// Fixed-size worker pool with a shared task queue and a wait-all barrier.
//
// Reference: Paddle's paddle/fluid/framework/threadpool.h (ThreadPool
// singleton used by parallel_do and async ops; Run/Wait interface).  Used
// internally by the native data-loader pipeline and exposed over the C ABI
// for host-side parallel work.
#include "common.h"

#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct ThreadPool {
  std::vector<std::thread> workers;
  std::deque<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;       // workers wait for tasks
  std::condition_variable idle_cv;  // Wait() blocks until drained
  size_t active = 0;
  bool stop = false;

  explicit ThreadPool(size_t n) {
    workers.reserve(n);
    for (size_t i = 0; i < n; ++i) {
      workers.emplace_back([this] { Loop(); });
    }
  }

  void Loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !tasks.empty(); });
        if (stop && tasks.empty()) return;
        task = std::move(tasks.front());
        tasks.pop_front();
        ++active;
      }
      task();
      {
        std::lock_guard<std::mutex> lk(mu);
        --active;
        if (tasks.empty() && active == 0) idle_cv.notify_all();
      }
    }
  }

  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push_back(std::move(fn));
    }
    cv.notify_one();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    idle_cv.wait(lk, [&] { return tasks.empty() && active == 0; });
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

PT_API void* pt_threadpool_create(size_t num_threads) {
  if (num_threads == 0) {
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  return new ThreadPool(num_threads);
}

PT_API size_t pt_threadpool_num_threads(void* h) {
  return static_cast<ThreadPool*>(h)->workers.size();
}

typedef void (*pt_task_fn)(void*);

PT_API void pt_threadpool_submit(void* h, pt_task_fn fn, void* arg) {
  static_cast<ThreadPool*>(h)->Submit([fn, arg] { fn(arg); });
}

PT_API void pt_threadpool_wait(void* h) {
  static_cast<ThreadPool*>(h)->Wait();
}

PT_API void pt_threadpool_destroy(void* h) {
  delete static_cast<ThreadPool*>(h);
}
