// TTL-lease service registry: elastic pserver membership + liveness.
//
// Reference: Paddle's go/pserver/etcd_client.go — a pserver registers under the
// lowest free index below the desired count with a TTL lease kept alive by
// heartbeats (Register :40-120), publishing its address for trainer-side
// discovery (go/pserver/client/etcd_client.go); an expired lease frees the
// index so a replacement can claim it, which is the failover story
// (go/cmd/pserver/pserver.go:34-45).  The port (as the JAX package) replaces
// the external etcd dependency with this in-tree native service: same lease semantics,
// lazy expiry on access (the master.cc timeout idiom), served in-process
// via the C ABI and over a line-oriented TCP protocol for multi-process
// clusters.
#include "common.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Entry {
  std::string addr;
  int64_t lease = 0;
  double ttl_s = 0;
  Clock::time_point renewed;
};

struct Registry {
  std::mutex mu;
  std::condition_variable cv;
  // kind -> (index -> entry); kind -> desired count (0 = unbounded)
  std::map<std::string, std::map<int, Entry>> kinds;
  std::map<std::string, int> desired;
  int64_t next_lease = 1;

  // TCP server.  Connection threads are DETACHED (a registry serves an
  // unbounded stream of short-lived heartbeat connections; keeping one
  // joinable std::thread per finished connection would grow without
  // bound); open fds are tracked so StopServe can shutdown() them, which
  // unblocks any thread parked in read().
  std::atomic<bool> serving{false};
  // set (under mu) by StopServe so handlers parked in WaitReady's cv —
  // which fd shutdown cannot unblock — wake and exit before teardown
  std::atomic<bool> stopping{false};
  std::atomic<int> active_conns{0};
  int listen_fd = -1;
  std::thread server_thread;
  std::set<int> conn_fds;
  std::mutex conn_mu;

  ~Registry() { StopServe(); }

  void ExpireLocked(const std::string& kind) {
    auto it = kinds.find(kind);
    if (it == kinds.end()) return;
    auto now = Clock::now();
    for (auto e = it->second.begin(); e != it->second.end();) {
      double age =
          std::chrono::duration<double>(now - e->second.renewed).count();
      if (age > e->second.ttl_s) {
        e = it->second.erase(e);  // lease expired -> index is free again
      } else {
        ++e;
      }
    }
  }

  void SetDesired(const std::string& kind, int n) {
    std::lock_guard<std::mutex> lk(mu);
    desired[kind] = n;
  }

  // Assign the LOWEST free index (reference etcd_client.go Register scans
  // slots 0..desired-1).  Returns index >= 0 and sets *lease, or -1 when
  // every slot below the desired count is held by a live lease.
  int Register(const std::string& kind, const std::string& addr,
               double ttl_s, int64_t* lease) {
    std::lock_guard<std::mutex> lk(mu);
    ExpireLocked(kind);
    auto& slots = kinds[kind];
    int limit = desired.count(kind) ? desired[kind] : 0;
    int idx = 0;
    for (;; ++idx) {
      if (limit > 0 && idx >= limit) return -1;
      if (!slots.count(idx)) break;
    }
    Entry e;
    e.addr = addr;
    e.ttl_s = ttl_s;
    e.lease = next_lease++;
    e.renewed = Clock::now();
    *lease = e.lease;
    slots[idx] = std::move(e);
    cv.notify_all();
    return idx;
  }

  // 1 = renewed; 0 = lease lost (expired and possibly re-assigned)
  int Heartbeat(const std::string& kind, int index, int64_t lease) {
    std::lock_guard<std::mutex> lk(mu);
    ExpireLocked(kind);
    auto kit = kinds.find(kind);
    if (kit == kinds.end()) return 0;
    auto it = kit->second.find(index);
    if (it == kit->second.end() || it->second.lease != lease) return 0;
    it->second.renewed = Clock::now();
    return 1;
  }

  int Deregister(const std::string& kind, int index, int64_t lease) {
    std::lock_guard<std::mutex> lk(mu);
    auto kit = kinds.find(kind);
    if (kit == kinds.end()) return 0;
    auto it = kit->second.find(index);
    if (it == kit->second.end() || it->second.lease != lease) return 0;
    kit->second.erase(it);
    cv.notify_all();
    return 1;
  }

  // newline-joined "<index> <addr>" lines for live entries
  std::string List(const std::string& kind) {
    std::lock_guard<std::mutex> lk(mu);
    ExpireLocked(kind);
    std::ostringstream os;
    auto kit = kinds.find(kind);
    if (kit != kinds.end()) {
      for (auto& kv : kit->second) {
        os << kv.first << " " << kv.second.addr << "\n";
      }
    }
    return os.str();
  }

  // block until `n` live entries of `kind` (1) or timeout (0)
  int WaitReady(const std::string& kind, size_t n, double timeout_s) {
    std::unique_lock<std::mutex> lk(mu);
    auto deadline = Clock::now() +
        std::chrono::duration_cast<Clock::duration>(
            std::chrono::duration<double>(timeout_s));
    for (;;) {
      if (stopping) return 0;  // registry is tearing down
      ExpireLocked(kind);
      if (kinds[kind].size() >= n) return 1;
      // re-check at least every 50ms: expiry is lazy, so a waiter must
      // poll even without notifications
      auto tick = Clock::now() + std::chrono::milliseconds(50);
      auto until = tick < deadline ? tick : deadline;
      if (cv.wait_until(lk, until) == std::cv_status::timeout &&
          Clock::now() >= deadline) {
        ExpireLocked(kind);
        return kinds[kind].size() >= n ? 1 : 0;
      }
    }
  }

  // ---- TCP protocol ------------------------------------------------------
  // DESIRE <kind> <n>\n                -> OK\n
  // REG <kind> <ttl_ms> <addr>\n       -> OK <index> <lease>\n | FULL\n
  // HB <kind> <index> <lease>\n        -> OK\n | GONE\n
  // DEREG <kind> <index> <lease>\n     -> OK\n | GONE\n
  // LIST <kind>\n                      -> OK\n<index> <addr>\n... .\n
  // WAIT <kind> <n> <timeout_ms>\n     -> OK\n | TIMEOUT\n
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
      {
        std::lock_guard<std::mutex> lk(conn_mu);
        if (!serving) {  // raced with StopServe: don't leak the fd
          close(fd);
          continue;
        }
        conn_fds.insert(fd);
      }
      ++active_conns;
      std::thread([this, fd] { HandleConn(fd); }).detach();
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
      std::string cmd, kind;
      is >> cmd;
      if (cmd == "DESIRE") {
        int n;
        is >> kind >> n;
        SetDesired(kind, n);
        WriteAll(fd, "OK\n");
      } else if (cmd == "REG") {
        int64_t ttl_ms;
        std::string addr;
        is >> kind >> ttl_ms >> addr;
        int64_t lease = 0;
        int idx = Register(kind, addr, ttl_ms / 1000.0, &lease);
        if (idx < 0) {
          WriteAll(fd, "FULL\n");
        } else {
          std::ostringstream os;
          os << "OK " << idx << " " << lease << "\n";
          WriteAll(fd, os.str());
        }
      } else if (cmd == "HB" || cmd == "DEREG") {
        int index;
        int64_t lease;
        is >> kind >> index >> lease;
        int ok = cmd == "HB" ? Heartbeat(kind, index, lease)
                             : Deregister(kind, index, lease);
        WriteAll(fd, ok ? "OK\n" : "GONE\n");
      } else if (cmd == "LIST") {
        is >> kind;
        WriteAll(fd, "OK\n" + List(kind) + ".\n");
      } else if (cmd == "WAIT") {
        size_t n;
        int64_t timeout_ms;
        is >> kind >> n >> timeout_ms;
        int ok = WaitReady(kind, n, timeout_ms / 1000.0);
        WriteAll(fd, ok ? "OK\n" : "TIMEOUT\n");
      } else {
        WriteAll(fd, "ERR\n");
      }
    }
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      conn_fds.erase(fd);
    }
    close(fd);
    --active_conns;
  }

  void StopServe() {
    if (!serving.exchange(false)) return;
    {
      // under mu so a WaitReady between its stopping-check and cv.wait
      // cannot miss the wakeup
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv.notify_all();
    shutdown(listen_fd, SHUT_RDWR);
    close(listen_fd);
    if (server_thread.joinable()) server_thread.join();
    {
      // unblock handler threads parked in read() on idle clients
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : conn_fds) shutdown(fd, SHUT_RDWR);
    }
    // wait until every detached handler has actually exited before
    // returning: the caller (pt_registry_destroy / ~Registry) deletes
    // this object next, so returning with a live handler would be a
    // use-after-free.  Handlers in read() are woken by the fd shutdown
    // above, handlers in WaitReady by stopping+notify_all; re-notify in
    // the loop in case one re-entered the cv before seeing the flag.
    // A generous deadline guards the must-wait: a handler stuck in a
    // syscall the fd shutdown cannot interrupt would otherwise spin this
    // loop forever with no diagnostic.  Returning with a live handler is
    // a use-after-free, so past the deadline we report and abort instead
    // of silently hanging or corrupting memory.
    auto deadline = Clock::now() + std::chrono::seconds(30);
    while (active_conns.load() > 0) {
      cv.notify_all();
      if (Clock::now() > deadline) {
        if (active_conns.load() == 0) break;  // exited during this tick
        std::fprintf(stderr,
                     "pt_registry: StopServe timed out after 30s with %d "
                     "handler thread(s) stuck; aborting to avoid "
                     "use-after-free\n",
                     active_conns.load());
        std::abort();
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
    }
    // every handler has exited: clear the flag so the in-process
    // WaitReady API and a later Serve() on this handle work again
    stopping = false;
  }
};

}  // namespace

PT_API void* pt_registry_create() { return new Registry(); }

PT_API void pt_registry_set_desired(void* h, const char* kind, int n) {
  static_cast<Registry*>(h)->SetDesired(kind, n);
}

PT_API int pt_registry_register(void* h, const char* kind, const char* addr,
                                double ttl_s, int64_t* lease) {
  return static_cast<Registry*>(h)->Register(kind, addr, ttl_s, lease);
}

PT_API int pt_registry_heartbeat(void* h, const char* kind, int index,
                                 int64_t lease) {
  return static_cast<Registry*>(h)->Heartbeat(kind, index, lease);
}

PT_API int pt_registry_deregister(void* h, const char* kind, int index,
                                  int64_t lease) {
  return static_cast<Registry*>(h)->Deregister(kind, index, lease);
}

// writes newline-joined "<index> <addr>" into buf (NUL-terminated)
// Returns the REQUIRED length (strlen, excluding NUL).  A return >=
// buflen means the copy was truncated and the caller must retry with a
// bigger buffer — silent truncation would drop live endpoints.
PT_API size_t pt_registry_list(void* h, const char* kind, char* buf,
                               size_t buflen) {
  std::string s = static_cast<Registry*>(h)->List(kind);
  std::snprintf(buf, buflen, "%s", s.c_str());
  return s.size();
}

PT_API int pt_registry_wait_ready(void* h, const char* kind, size_t n,
                                  double timeout_s) {
  return static_cast<Registry*>(h)->WaitReady(kind, n, timeout_s);
}

PT_API int pt_registry_serve(void* h, int port) {
  return static_cast<Registry*>(h)->Serve(port);
}

PT_API void pt_registry_stop(void* h) {
  static_cast<Registry*>(h)->StopServe();
}

PT_API void pt_registry_destroy(void* h) {
  delete static_cast<Registry*>(h);
}
