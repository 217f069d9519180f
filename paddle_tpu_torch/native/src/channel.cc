// Go-style CSP channels carrying fixed-size elements.
//
// Reference: Paddle's paddle/fluid/framework/channel.h:24,42
// (MakeChannel / Channel<T>), details/buffered_channel.h (bounded queue with
// send/recv condition variables) and details/unbuffered_channel.h (rendezvous
// handoff).  Semantics preserved here:
//   * capacity > 0  -> buffered: send blocks while full, recv blocks while
//     empty.
//   * capacity == 0 -> unbuffered: send blocks until a receiver has taken the
//     element (rendezvous).
//   * close() wakes all waiters; recv drains remaining buffered elements and
//     then fails; send on a closed channel fails.
#include "common.h"

#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Channel {
  size_t elem_size;
  size_t capacity;  // 0 = unbuffered rendezvous
  std::deque<std::vector<char>> buf;
  uint64_t pushed = 0;   // total elements ever enqueued
  uint64_t popped = 0;   // total elements ever dequeued
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full;   // buffered senders wait here
  std::condition_variable not_empty;  // receivers wait here
  std::condition_variable consumed;   // unbuffered senders wait here
};

}  // namespace

PT_API void* pt_channel_create(size_t elem_size, size_t capacity) {
  auto* c = new Channel();
  c->elem_size = elem_size;
  c->capacity = capacity;
  return c;
}

PT_API int pt_channel_send(void* h, const void* data) {
  auto* c = static_cast<Channel*>(h);
  std::unique_lock<std::mutex> lk(c->mu);
  if (c->capacity > 0) {
    c->not_full.wait(
        lk, [&] { return c->closed || c->buf.size() < c->capacity; });
    if (c->closed) return 0;
    c->buf.emplace_back(static_cast<const char*>(data),
                        static_cast<const char*>(data) + c->elem_size);
    ++c->pushed;
    c->not_empty.notify_one();
    return 1;
  }
  // Unbuffered: enqueue, then wait until a receiver has dequeued our element.
  // FIFO order means our element is gone once popped reaches our sequence no.
  if (c->closed) return 0;
  c->buf.emplace_back(static_cast<const char*>(data),
                      static_cast<const char*>(data) + c->elem_size);
  uint64_t myseq = ++c->pushed;
  c->not_empty.notify_one();
  c->consumed.wait(lk, [&] { return c->closed || c->popped >= myseq; });
  return c->popped >= myseq ? 1 : 0;
}

PT_API int pt_channel_recv(void* h, void* out) {
  auto* c = static_cast<Channel*>(h);
  std::unique_lock<std::mutex> lk(c->mu);
  c->not_empty.wait(lk, [&] { return c->closed || !c->buf.empty(); });
  if (c->buf.empty()) return 0;  // closed and fully drained
  std::memcpy(out, c->buf.front().data(), c->elem_size);
  c->buf.pop_front();
  ++c->popped;
  if (c->capacity > 0) {
    c->not_full.notify_one();
  } else {
    c->consumed.notify_all();
  }
  return 1;
}

PT_API void pt_channel_close(void* h) {
  auto* c = static_cast<Channel*>(h);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->closed = true;
    // Unbuffered: pending elements belong to senders that will now report
    // failure — drop them so a message is never both "not sent" and
    // delivered.  (Buffered elements were successfully sent; recv drains
    // them, matching the reference's buffered_channel close semantics.)
    if (c->capacity == 0) c->buf.clear();
  }
  c->not_full.notify_all();
  c->not_empty.notify_all();
  c->consumed.notify_all();
}

PT_API size_t pt_channel_size(void* h) {
  auto* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->buf.size();
}

PT_API int pt_channel_is_closed(void* h) {
  auto* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->closed ? 1 : 0;
}

PT_API void pt_channel_destroy(void* h) { delete static_cast<Channel*>(h); }
