// Fault-tolerant task-dispatch master: the Go cloud master, rebuilt native.
//
// Reference: Paddle's go/master/service.go — dataset partitioned into
// tasks (:106), todo/pending/done queues (:80-88), GetTask per pass (:368),
// TaskFinished (:411), TaskFailed (:455), timeout re-dispatch
// (checkTimeoutFunc :341), discard after failureMax (processFailedTask
// :313), state snapshot/recover (:207,:166 — etcd there, an atomically
// replaced snapshot file here; multi-host deployments put it on shared
// storage).  Trainers are stateless consumers: any may die or join at any
// time (doc/design/cluster_train/README.md), which is the elasticity story
// the PyTorch port keeps for the host-side data plane while the cards run
// the compute.  The same source as the JAX package's: the same task ids,
// dispatch order and wire for the same dataset.
//
// Served two ways: in-process via the C ABI (single-host multi-thread), and
// over a line-oriented TCP protocol (multi-process / multi-host trainers),
// replacing the Go net/rpc + cgo client stack.
#include "common.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Task {
  int64_t id = 0;
  int failures = 0;
  std::vector<std::string> chunks;
};

struct Master {
  std::mutex mu;
  std::deque<Task> todo;
  std::map<int64_t, std::pair<Task, Clock::time_point>> pending;
  std::vector<Task> done;
  int64_t discarded = 0;
  int64_t next_id = 0;
  int64_t pass = 0;
  int failure_max;
  double timeout_s;
  std::string snapshot_path;
  bool has_dataset = false;

  // TCP server
  std::atomic<bool> serving{false};
  int listen_fd = -1;
  std::thread server_thread;
  std::vector<std::thread> conn_threads;
  std::mutex conn_mu;

  Master(int fmax, double tsec, const char* snap)
      : failure_max(fmax), timeout_s(tsec),
        snapshot_path(snap ? snap : "") {
    if (!snapshot_path.empty()) Recover();
  }

  ~Master() { StopServe(); }

  // ---- snapshot / recover (reference service.go:207 snapshot, :166) ------
  void SnapshotLocked() {
    if (snapshot_path.empty()) return;
    std::string tmp = snapshot_path + ".tmp";
    {
      std::ofstream f(tmp, std::ios::trunc);
      f << "ptmaster1 " << pass << " " << next_id << " " << discarded
        << "\n";
      auto dump = [&f](const Task& t) {
        f << t.id << " " << t.failures << " " << t.chunks.size() << "\n";
        for (auto& c : t.chunks) f << c << "\n";
      };
      // pending tasks are persisted as todo: after a master restart their
      // trainers may be gone, so they must be re-dispatched (the reference
      // reaches the same end state via recover + timeout).
      f << (todo.size() + pending.size()) << "\n";
      for (auto& t : todo) dump(t);
      for (auto& kv : pending) dump(kv.second.first);
      f << done.size() << "\n";
      for (auto& t : done) dump(t);
    }
    std::rename(tmp.c_str(), snapshot_path.c_str());
  }

  void Recover() {
    std::ifstream f(snapshot_path);
    if (!f) return;
    std::string magic;
    f >> magic;
    if (magic != "ptmaster1") return;
    f >> pass >> next_id >> discarded;
    auto load = [&f](Task& t) {
      size_t n;
      f >> t.id >> t.failures >> n;
      f.ignore();  // trailing newline
      t.chunks.resize(n);
      for (auto& c : t.chunks) std::getline(f, c);
    };
    size_t ntodo, ndone;
    f >> ntodo;
    f.ignore();
    todo.resize(ntodo);
    for (auto& t : todo) load(t);
    f >> ndone;
    f.ignore();
    done.resize(ndone);
    for (auto& t : done) load(t);
    has_dataset = ntodo + ndone > 0;
  }

  // ---- dataset partition (reference service.go:106 partition) ------------
  int SetDataset(const std::vector<std::string>& chunks,
                 size_t chunks_per_task) {
    std::lock_guard<std::mutex> lk(mu);
    if (has_dataset) return 0;  // idempotent, like the reference's once-only
    if (chunks_per_task == 0) chunks_per_task = 1;
    for (size_t i = 0; i < chunks.size(); i += chunks_per_task) {
      Task t;
      t.id = next_id++;
      for (size_t j = i; j < chunks.size() && j < i + chunks_per_task; ++j) {
        t.chunks.push_back(chunks[j]);
      }
      todo.push_back(std::move(t));
    }
    has_dataset = true;
    SnapshotLocked();
    return 1;
  }

  void CheckTimeoutsLocked() {
    auto now = Clock::now();
    for (auto it = pending.begin(); it != pending.end();) {
      double waited =
          std::chrono::duration<double>(now - it->second.second).count();
      if (waited > timeout_s) {
        RequeueLocked(it->second.first);
        it = pending.erase(it);
      } else {
        ++it;
      }
    }
  }

  void RequeueLocked(Task t) {
    t.failures++;
    if (t.failures > failure_max) {
      ++discarded;  // reference processFailedTask: discard permanently
    } else {
      todo.push_back(std::move(t));
    }
  }

  // status: 1 = task returned, 0 = none available now (pending outstanding),
  // 2 = task returned + new pass just started
  int GetTask(Task* out) {
    std::lock_guard<std::mutex> lk(mu);
    CheckTimeoutsLocked();
    bool new_pass = false;
    if (todo.empty()) {
      if (!pending.empty() || done.empty()) return 0;
      // all tasks done -> start the next pass (reference service.go GetTask)
      for (auto& t : done) {
        t.failures = 0;
        todo.push_back(std::move(t));
      }
      done.clear();
      ++pass;
      new_pass = true;
    }
    Task t = std::move(todo.front());
    todo.pop_front();
    pending[t.id] = {t, Clock::now()};
    *out = std::move(t);
    SnapshotLocked();
    return new_pass ? 2 : 1;
  }

  int TaskFinished(int64_t id) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = pending.find(id);
    if (it == pending.end()) return 0;
    Task t = std::move(it->second.first);
    t.failures = 0;
    pending.erase(it);
    done.push_back(std::move(t));
    SnapshotLocked();
    return 1;
  }

  int TaskFailed(int64_t id) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = pending.find(id);
    if (it == pending.end()) return 0;
    Task t = std::move(it->second.first);
    pending.erase(it);
    RequeueLocked(std::move(t));
    SnapshotLocked();
    return 1;
  }

  void Counts(int64_t* out) {
    std::lock_guard<std::mutex> lk(mu);
    CheckTimeoutsLocked();
    out[0] = (int64_t)todo.size();
    out[1] = (int64_t)pending.size();
    out[2] = (int64_t)done.size();
    out[3] = discarded;
    out[4] = pass;
  }

  // ---- TCP protocol ------------------------------------------------------
  // GET\n                     -> OK <status> <id>\n<chunk>\n...\n.\n | NONE\n
  // FIN <id>\n                -> OK\n | ERR\n
  // FAIL <id>\n               -> OK\n | ERR\n
  // SET <per_task> <n>\n<chunk>\n...  -> OK\n
  // INFO\n                    -> OK <todo> <pending> <done> <disc> <pass>\n
  int Serve(int port) {
    listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return -1;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)port);
    if (bind(listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
      close(listen_fd);
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(listen_fd, (sockaddr*)&addr, &alen);
    int actual_port = ntohs(addr.sin_port);
    listen(listen_fd, 64);
    serving = true;
    server_thread = std::thread([this] { AcceptLoop(); });
    return actual_port;
  }

  void AcceptLoop() {
    while (serving) {
      int fd = accept(listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      std::lock_guard<std::mutex> lk(conn_mu);
      conn_threads.emplace_back([this, fd] { HandleConn(fd); });
    }
  }

  static bool ReadLine(int fd, std::string* line) {
    line->clear();
    char ch;
    for (;;) {
      ssize_t r = read(fd, &ch, 1);
      if (r <= 0) return false;
      if (ch == '\n') return true;
      line->push_back(ch);
    }
  }

  static void WriteAll(int fd, const std::string& s) {
    size_t off = 0;
    while (off < s.size()) {
      ssize_t w = write(fd, s.data() + off, s.size() - off);
      if (w <= 0) return;
      off += (size_t)w;
    }
  }

  void HandleConn(int fd) {
    std::string line;
    while (serving && ReadLine(fd, &line)) {
      std::istringstream is(line);
      std::string cmd;
      is >> cmd;
      if (cmd == "GET") {
        Task t;
        int st = GetTask(&t);
        if (st == 0) {
          WriteAll(fd, "NONE\n");
        } else {
          std::ostringstream os;
          os << "OK " << st << " " << t.id << "\n";
          for (auto& c : t.chunks) os << c << "\n";
          os << ".\n";
          WriteAll(fd, os.str());
        }
      } else if (cmd == "FIN" || cmd == "FAIL") {
        int64_t id;
        is >> id;
        int ok = cmd == "FIN" ? TaskFinished(id) : TaskFailed(id);
        WriteAll(fd, ok ? "OK\n" : "ERR\n");
      } else if (cmd == "SET") {
        size_t per_task, n;
        is >> per_task >> n;
        std::vector<std::string> chunks(n);
        bool good = true;
        for (auto& c : chunks) {
          if (!ReadLine(fd, &c)) {
            good = false;
            break;
          }
        }
        if (good) {
          SetDataset(chunks, per_task);
          WriteAll(fd, "OK\n");
        }
      } else if (cmd == "INFO") {
        int64_t c[5];
        Counts(c);
        std::ostringstream os;
        os << "OK " << c[0] << " " << c[1] << " " << c[2] << " " << c[3]
           << " " << c[4] << "\n";
        WriteAll(fd, os.str());
      } else {
        WriteAll(fd, "ERR unknown\n");
      }
    }
    close(fd);
  }

  void StopServe() {
    if (!serving.exchange(false)) return;
    shutdown(listen_fd, SHUT_RDWR);
    close(listen_fd);
    if (server_thread.joinable()) server_thread.join();
    std::lock_guard<std::mutex> lk(conn_mu);
    for (auto& t : conn_threads) {
      if (t.joinable()) t.join();
    }
    conn_threads.clear();
  }
};

}  // namespace

PT_API void* pt_master_create(int failure_max, double timeout_s,
                              const char* snapshot_path) {
  return new Master(failure_max, timeout_s, snapshot_path);
}

PT_API int pt_master_set_dataset(void* h, const char* const* chunks,
                                 size_t n, size_t chunks_per_task) {
  std::vector<std::string> v(chunks, chunks + n);
  return static_cast<Master*>(h)->SetDataset(v, chunks_per_task);
}

PT_API int pt_master_has_dataset(void* h) {
  std::lock_guard<std::mutex> lk(static_cast<Master*>(h)->mu);
  return static_cast<Master*>(h)->has_dataset ? 1 : 0;
}

// Returns status (0 none, 1 task, 2 task+new pass); fills id and writes
// newline-joined chunks into buf (truncated to buflen-1, NUL-terminated).
PT_API int pt_master_get_task(void* h, int64_t* id, char* buf,
                              size_t buflen) {
  Task t;
  int st = static_cast<Master*>(h)->GetTask(&t);
  if (st == 0) return 0;
  *id = t.id;
  std::string joined;
  for (size_t i = 0; i < t.chunks.size(); ++i) {
    if (i) joined += "\n";
    joined += t.chunks[i];
  }
  std::snprintf(buf, buflen, "%s", joined.c_str());
  return st;
}

PT_API int pt_master_task_finished(void* h, int64_t id) {
  return static_cast<Master*>(h)->TaskFinished(id);
}

PT_API int pt_master_task_failed(void* h, int64_t id) {
  return static_cast<Master*>(h)->TaskFailed(id);
}

// out: [todo, pending, done, discarded, pass]
PT_API void pt_master_counts(void* h, int64_t* out) {
  static_cast<Master*>(h)->Counts(out);
}

PT_API int pt_master_serve(void* h, int port) {
  return static_cast<Master*>(h)->Serve(port);
}

PT_API void pt_master_stop(void* h) { static_cast<Master*>(h)->StopServe(); }

PT_API void pt_master_destroy(void* h) { delete static_cast<Master*>(h); }
