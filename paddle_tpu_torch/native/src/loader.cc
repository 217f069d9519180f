// Native data-loader pipeline: shuffle -> batch -> prefetch, off the GIL.
//
// Reference: Paddle's paddle/fluid/framework/reader.h (ReaderBase +
// decorator readers: shuffle/batch/double-buffer created by
// operators/create_reader_op.cc) and the legacy async provider
// gserver/dataproviders/PyDataProvider2.cpp (Python generator feeding a
// native buffered pool).  Python stays the sample *producer* (ctypes `push`
// releases the GIL during the copy) while all shuffling, batch assembly
// (the heavy stacking memcpy) and prefetch buffering run on a native worker
// thread over buddy-allocated staging memory — the host input pipeline
// overlaps device compute, as the double_buffer reader does.
//
// Pipeline stages (single producer or many, one internal worker):
//   push(sample)        -> shuffle buffer (seeded mt19937 shuffle when full)
//   worker thread       -> pops batch_size samples, stacks each slot into a
//                          contiguous per-slot batch buffer
//   ready queue         -> bounded (prefetch_depth), gives backpressure
//   next()/release()    -> consumer borrows a batch, returns it to the pool
//
// Epoch protocol: finish_epoch() flushes the shuffle buffer and enqueues an
// epoch-end marker; next() returns nullptr exactly once per epoch, after
// which the pipeline is ready for the next epoch's pushes.
#include "common.h"

#include <algorithm>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

// from allocator.cc
void* pt_internal_buddy_create(size_t min_log2, size_t chunk_log2);
void* pt_internal_buddy_alloc(void* h, size_t n);
void pt_internal_buddy_free(void* h, void* p);
void pt_internal_buddy_destroy(void* h);

namespace {

struct Batch {
  std::vector<char*> slots;  // one stacked buffer per slot
  size_t n = 0;              // samples in this batch
};

struct Loader {
  std::vector<size_t> slot_nbytes;
  size_t sample_nbytes = 0;  // sum of slots, layout: slot0|slot1|...
  size_t batch_size;
  size_t shuffle_buf;  // 0 = no shuffling (FIFO)
  size_t prefetch_depth;
  bool drop_last;
  std::mt19937_64 rng;

  void* arena;  // buddy allocator owning all staging memory

  std::mutex mu;
  std::condition_variable work_cv;   // worker waits for samples/flush
  std::condition_variable ready_cv;  // consumer waits for batches
  std::condition_variable space_cv;  // worker waits for ready-queue space
  std::condition_variable push_cv;   // producers wait while pending is full

  std::vector<char*> shuffle_pool;   // samples awaiting shuffle
  std::deque<char*> pending;         // shuffled samples awaiting batching
  std::deque<Batch*> ready;          // assembled batches (+nullptr = epoch end)
  bool flush = false;                // epoch flush requested
  bool stop = false;
  uint64_t epochs_ended = 0;

  std::thread worker;

  Loader(size_t n_slots, const size_t* nbytes, size_t bs, size_t shuf,
         uint64_t seed, size_t depth, bool drop)
      : slot_nbytes(nbytes, nbytes + n_slots),
        batch_size(bs),
        shuffle_buf(shuf),
        prefetch_depth(depth ? depth : 2),
        drop_last(drop),
        rng(seed) {
    for (size_t b : slot_nbytes) sample_nbytes += b;
    arena = pt_internal_buddy_create(6, 26);
    worker = std::thread([this] { WorkerLoop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    work_cv.notify_all();
    ready_cv.notify_all();
    space_cv.notify_all();
    push_cv.notify_all();
    worker.join();
    for (char* s : shuffle_pool) pt_internal_buddy_free(arena, s);
    for (char* s : pending) pt_internal_buddy_free(arena, s);
    for (Batch* b : ready) FreeBatch(b);
    pt_internal_buddy_destroy(arena);
  }

  void FreeBatch(Batch* b) {
    if (!b) return;
    for (char* s : b->slots) pt_internal_buddy_free(arena, s);
    delete b;
  }

  int Push(const void* const* slot_ptrs) {
    char* s = static_cast<char*>(
        pt_internal_buddy_alloc(arena, sample_nbytes));
    if (!s) return 0;
    size_t off = 0;
    for (size_t i = 0; i < slot_nbytes.size(); ++i) {
      std::memcpy(s + off, slot_ptrs[i], slot_nbytes[i]);
      off += slot_nbytes[i];
    }
    std::unique_lock<std::mutex> lk(mu);
    // backpressure: bound staged samples so a fast producer can't outrun
    // the consumer unboundedly (prefetch_depth bounds assembled batches;
    // this bounds raw samples)
    size_t cap = std::max(shuffle_buf, batch_size) + 2 * batch_size;
    push_cv.wait(lk, [&] { return stop || pending.size() < cap; });
    if (stop) {
      pt_internal_buddy_free(arena, s);
      return 0;
    }
    if (shuffle_buf == 0) {
      pending.push_back(s);
      if (pending.size() >= batch_size) work_cv.notify_one();
    } else {
      shuffle_pool.push_back(s);
      if (shuffle_pool.size() >= shuffle_buf) {
        DrainShufflePoolLocked();
        work_cv.notify_one();
      }
    }
    return 1;
  }

  void DrainShufflePoolLocked() {
    std::shuffle(shuffle_pool.begin(), shuffle_pool.end(), rng);
    for (char* s : shuffle_pool) pending.push_back(s);
    shuffle_pool.clear();
  }

  void FinishEpoch() {
    {
      std::lock_guard<std::mutex> lk(mu);
      DrainShufflePoolLocked();
      flush = true;
    }
    work_cv.notify_one();
  }

  void WorkerLoop() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      work_cv.wait(lk, [&] {
        return stop || pending.size() >= batch_size || flush;
      });
      if (stop) return;
      if (pending.size() < batch_size && !flush) continue;
      size_t take = std::min(pending.size(), batch_size);
      if (take == 0 || (take < batch_size && !flush)) {
        // flush with nothing left: emit epoch end
        if (flush && pending.empty()) {
          flush = false;
          EmitLocked(lk, nullptr);
        }
        continue;
      }
      if (take < batch_size && drop_last) {
        for (size_t i = 0; i < take; ++i) {
          pt_internal_buddy_free(arena, pending.front());
          pending.pop_front();
        }
        push_cv.notify_all();
        continue;
      }
      std::vector<char*> samples(pending.begin(), pending.begin() + take);
      pending.erase(pending.begin(), pending.begin() + take);
      push_cv.notify_all();
      bool end_after =
          flush && pending.empty();  // this is the epoch's last batch
      if (end_after) flush = false;
      lk.unlock();

      // heavy part outside the lock: stack slot-wise
      Batch* b = new Batch();
      b->n = take;
      b->slots.resize(slot_nbytes.size());
      size_t off = 0;
      for (size_t i = 0; i < slot_nbytes.size(); ++i) {
        b->slots[i] = static_cast<char*>(
            pt_internal_buddy_alloc(arena, slot_nbytes[i] * take));
        for (size_t j = 0; j < take; ++j) {
          std::memcpy(b->slots[i] + j * slot_nbytes[i], samples[j] + off,
                      slot_nbytes[i]);
        }
        off += slot_nbytes[i];
      }
      for (char* s : samples) pt_internal_buddy_free(arena, s);

      lk.lock();
      EmitLocked(lk, b);
      if (end_after) EmitLocked(lk, nullptr);
    }
  }

  // enqueue onto the bounded ready queue (nullptr = epoch end marker)
  void EmitLocked(std::unique_lock<std::mutex>& lk, Batch* b) {
    space_cv.wait(lk, [&] { return stop || ready.size() < prefetch_depth; });
    if (stop) {
      FreeBatch(b);
      return;
    }
    ready.push_back(b);
    if (!b) ++epochs_ended;
    ready_cv.notify_one();
  }

  Batch* Next() {
    std::unique_lock<std::mutex> lk(mu);
    ready_cv.wait(lk, [&] { return stop || !ready.empty(); });
    if (stop && ready.empty()) return nullptr;
    Batch* b = ready.front();
    ready.pop_front();
    space_cv.notify_one();
    return b;
  }
};

}  // namespace

PT_API void* pt_loader_create(size_t n_slots, const size_t* slot_nbytes,
                              size_t batch_size, size_t shuffle_buf,
                              uint64_t seed, size_t prefetch_depth,
                              int drop_last) {
  return new Loader(n_slots, slot_nbytes, batch_size, shuffle_buf, seed,
                    prefetch_depth, drop_last != 0);
}

PT_API int pt_loader_push(void* h, const void* const* slot_ptrs) {
  return static_cast<Loader*>(h)->Push(slot_ptrs);
}

PT_API void pt_loader_finish_epoch(void* h) {
  static_cast<Loader*>(h)->FinishEpoch();
}

// Returns a batch handle, or NULL at epoch end (once per finish_epoch).
PT_API void* pt_loader_next(void* h) {
  return static_cast<Loader*>(h)->Next();
}

PT_API size_t pt_batch_n(void* b) { return static_cast<Batch*>(b)->n; }

PT_API void* pt_batch_slot(void* b, size_t i) {
  return static_cast<Batch*>(b)->slots[i];
}

PT_API void pt_batch_release(void* h, void* b) {
  static_cast<Loader*>(h)->FreeBatch(static_cast<Batch*>(b));
}

PT_API void pt_loader_destroy(void* h) { delete static_cast<Loader*>(h); }
