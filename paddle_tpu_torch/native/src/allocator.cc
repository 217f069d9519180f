// Power-of-two buddy allocator over malloc'd arena chunks.
//
// Reference: Paddle's paddle/fluid/memory/detail/buddy_allocator.h:33 and
// system_allocator.cc — the reference manages GPU/pinned-host memory with a
// buddy system (split on alloc, coalesce buddies on free, fall back to the
// system allocator for oversize requests).  Here the device heap belongs to
// PyTorch's CUDA caching allocator, so this allocator serves the host side:
// staging buffers for the native data-loader pipeline and any runtime
// service needing cheap recycled buffers without malloc churn.
//
// Design: headerless buddy with external metadata.  Arena chunks of
// 1<<chunk_log2 bytes are obtained from aligned_alloc; free blocks live in
// per-level free lists keyed by byte offset inside their chunk, so the buddy
// of a block at offset o on level L is simply o ^ (1<<L).  Requests larger
// than a chunk go straight to the system allocator ("huge" path), mirroring
// the reference's fallback.
#include "common.h"

#include <cstdlib>
#include <map>
#include <mutex>
#include <set>
#include <unordered_map>
#include <vector>

namespace {

struct Chunk {
  char* base;
};

struct BuddyAllocator {
  size_t min_log2;    // smallest block: 1<<min_log2 bytes
  size_t chunk_log2;  // arena chunk: 1<<chunk_log2 bytes
  std::mutex mu;
  // chunk base address -> chunk record, ordered so we can find the chunk
  // containing any pointer with upper_bound.
  std::map<char*, Chunk> chunks;
  // free_lists[level] = set of free block addresses of size 1<<level
  std::vector<std::set<char*>> free_lists;
  // allocated block -> level
  std::unordered_map<void*, size_t> allocated;
  // oversize allocations served directly by malloc: ptr -> size
  std::unordered_map<void*, size_t> huge;
  // stats (bytes)
  uint64_t arena_bytes = 0;
  uint64_t in_use = 0;
  uint64_t peak_in_use = 0;

  BuddyAllocator(size_t min_l, size_t chunk_l)
      : min_log2(min_l), chunk_log2(chunk_l), free_lists(chunk_l + 1) {}

  ~BuddyAllocator() {
    for (auto& kv : chunks) std::free(kv.first);
    for (auto& kv : huge) std::free(kv.first);
  }

  size_t LevelFor(size_t n) const {
    size_t level = min_log2;
    while ((size_t(1) << level) < n) ++level;
    return level;
  }

  char* ChunkBaseOf(char* p) const {
    auto it = chunks.upper_bound(p);
    --it;  // largest base <= p; caller guarantees p is inside some chunk
    return it->first;
  }

  void* Alloc(size_t n) {
    if (n == 0) n = 1;
    std::lock_guard<std::mutex> lk(mu);
    if (n > (size_t(1) << chunk_log2)) {
      void* p = std::malloc(n);
      if (!p) return nullptr;
      huge[p] = n;
      in_use += n;
      arena_bytes += n;
      if (in_use > peak_in_use) peak_in_use = in_use;
      return p;
    }
    size_t level = LevelFor(n);
    // find the lowest level >= `level` with a free block
    size_t l = level;
    while (l <= chunk_log2 && free_lists[l].empty()) ++l;
    if (l > chunk_log2) {
      char* base =
          static_cast<char*>(std::aligned_alloc(4096, size_t(1) << chunk_log2));
      if (!base) return nullptr;
      chunks[base] = Chunk{base};
      arena_bytes += size_t(1) << chunk_log2;
      free_lists[chunk_log2].insert(base);
      l = chunk_log2;
    }
    char* block = *free_lists[l].begin();
    free_lists[l].erase(free_lists[l].begin());
    // split down to the requested level, freeing the upper buddy each time
    while (l > level) {
      --l;
      free_lists[l].insert(block + (size_t(1) << l));
    }
    allocated[block] = level;
    in_use += size_t(1) << level;
    if (in_use > peak_in_use) peak_in_use = in_use;
    return block;
  }

  void Free(void* p) {
    if (!p) return;
    std::lock_guard<std::mutex> lk(mu);
    auto hit = huge.find(p);
    if (hit != huge.end()) {
      in_use -= hit->second;
      arena_bytes -= hit->second;
      std::free(p);
      huge.erase(hit);
      return;
    }
    auto it = allocated.find(p);
    if (it == allocated.end()) return;  // double free / foreign pointer: no-op
    size_t level = it->second;
    allocated.erase(it);
    in_use -= size_t(1) << level;
    char* block = static_cast<char*>(p);
    char* base = ChunkBaseOf(block);
    // coalesce with free buddies as far up as possible
    while (level < chunk_log2) {
      size_t offset = size_t(block - base);
      char* buddy = base + (offset ^ (size_t(1) << level));
      auto& fl = free_lists[level];
      auto bit = fl.find(buddy);
      if (bit == fl.end()) break;
      fl.erase(bit);
      if (buddy < block) block = buddy;
      ++level;
    }
    free_lists[level].insert(block);
  }
};

}  // namespace

// Internal C++ access for sibling translation units (loader.cc).
void* pt_internal_buddy_create(size_t min_log2, size_t chunk_log2) {
  return new BuddyAllocator(min_log2, chunk_log2);
}
void* pt_internal_buddy_alloc(void* h, size_t n) {
  return static_cast<BuddyAllocator*>(h)->Alloc(n);
}
void pt_internal_buddy_free(void* h, void* p) {
  static_cast<BuddyAllocator*>(h)->Free(p);
}
void pt_internal_buddy_destroy(void* h) {
  delete static_cast<BuddyAllocator*>(h);
}

PT_API void* pt_buddy_create(size_t min_log2, size_t chunk_log2) {
  if (min_log2 == 0) min_log2 = 6;     // 64 B
  if (chunk_log2 == 0) chunk_log2 = 26;  // 64 MiB
  if (chunk_log2 < min_log2) chunk_log2 = min_log2;
  return new BuddyAllocator(min_log2, chunk_log2);
}

PT_API void* pt_buddy_alloc(void* h, size_t n) {
  return static_cast<BuddyAllocator*>(h)->Alloc(n);
}

PT_API void pt_buddy_free(void* h, void* p) {
  static_cast<BuddyAllocator*>(h)->Free(p);
}

// out: [arena_bytes, in_use, peak_in_use, num_chunks]
PT_API void pt_buddy_stats(void* h, uint64_t* out) {
  auto* a = static_cast<BuddyAllocator*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  out[0] = a->arena_bytes;
  out[1] = a->in_use;
  out[2] = a->peak_in_use;
  out[3] = a->chunks.size() + a->huge.size();
}

PT_API void pt_buddy_destroy(void* h) {
  delete static_cast<BuddyAllocator*>(h);
}
