// Shared-memory object arena: the data plane of the per-node object store.
//
// Analog of the reference's Plasma store arena
// (src/ray/object_manager/plasma/{store.h:55,dlmalloc.cc}): one POSIX shm
// segment per node, mmap'd by every process on the node, so object payloads
// are written once and read zero-copy everywhere. Unlike plasma there is no
// fd-passing protocol: the segment has a well-known name per node and clients
// attach directly; allocation metadata lives only in the store daemon (the
// single process that calls alloc/free), which hands out offsets over RPC.
//
// Exposed as a plain C API for ctypes binding (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Arena {
  std::string name;
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  bool owner = false;
  // First-fit free list with coalescing. Only meaningful in the owner
  // (daemon) process; attachers never allocate.
  std::map<uint64_t, uint64_t> free_blocks;   // offset -> size
  std::map<uint64_t, uint64_t> alloc_blocks;  // offset -> size
  uint64_t used = 0;
  std::mutex mu;
};

std::mutex g_mu;
std::vector<Arena*> g_arenas;

int register_arena(Arena* a) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_arenas.push_back(a);
  return static_cast<int>(g_arenas.size() - 1);
}

Arena* get_arena(int handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (handle < 0 || handle >= static_cast<int>(g_arenas.size())) return nullptr;
  return g_arenas[handle];
}

constexpr uint64_t kAlign = 64;  // cache-line align payloads

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

}  // namespace

extern "C" {

// Create (daemon) or attach (client) the node's arena segment.
// Returns handle >= 0, or -1 on failure.
int arena_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed session
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -1;
  if (ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    close(fd);
    shm_unlink(name);
    return -1;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return -1;
  }
  Arena* a = new Arena();
  a->name = name;
  a->base = static_cast<uint8_t*>(base);
  a->capacity = capacity;
  a->owner = true;
  a->free_blocks[0] = capacity;
  return register_arena(a);
}

int arena_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  uint64_t capacity = static_cast<uint64_t>(st.st_size);
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  Arena* a = new Arena();
  a->name = name;
  a->base = static_cast<uint8_t*>(base);
  a->capacity = capacity;
  a->owner = false;
  return register_arena(a);
}

uint64_t arena_capacity(int handle) {
  Arena* a = get_arena(handle);
  return a ? a->capacity : 0;
}

void* arena_base(int handle) {
  Arena* a = get_arena(handle);
  return a ? a->base : nullptr;
}

// Allocate `size` bytes; returns offset, or UINT64_MAX if out of memory.
// Daemon-only.
uint64_t arena_alloc(int handle, uint64_t size) {
  Arena* a = get_arena(handle);
  if (!a || !a->owner || size == 0) return UINT64_MAX;
  uint64_t need = align_up(size);
  std::lock_guard<std::mutex> lock(a->mu);
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= need) {
      uint64_t off = it->first;
      uint64_t remaining = it->second - need;
      a->free_blocks.erase(it);
      if (remaining > 0) a->free_blocks[off + need] = remaining;
      a->alloc_blocks[off] = need;
      a->used += need;
      return off;
    }
  }
  return UINT64_MAX;
}

// Free a previously allocated offset. Returns 0 on success. Daemon-only.
int arena_free(int handle, uint64_t offset) {
  Arena* a = get_arena(handle);
  if (!a || !a->owner) return -1;
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->alloc_blocks.find(offset);
  if (it == a->alloc_blocks.end()) return -1;
  uint64_t size = it->second;
  a->alloc_blocks.erase(it);
  a->used -= size;
  // Insert into free list and coalesce with neighbors.
  auto ins = a->free_blocks.emplace(offset, size).first;
  if (ins != a->free_blocks.begin()) {
    auto prev = std::prev(ins);
    if (prev->first + prev->second == ins->first) {
      prev->second += ins->second;
      a->free_blocks.erase(ins);
      ins = prev;
    }
  }
  auto next = std::next(ins);
  if (next != a->free_blocks.end() && ins->first + ins->second == next->first) {
    ins->second += next->second;
    a->free_blocks.erase(next);
  }
  return 0;
}

uint64_t arena_used(int handle) {
  Arena* a = get_arena(handle);
  if (!a) return 0;
  std::lock_guard<std::mutex> lock(a->mu);
  return a->used;
}

uint64_t arena_largest_free(int handle) {
  Arena* a = get_arena(handle);
  if (!a) return 0;
  std::lock_guard<std::mutex> lock(a->mu);
  uint64_t best = 0;
  for (auto& kv : a->free_blocks)
    if (kv.second > best) best = kv.second;
  return best;
}

// Detach; if unlink != 0 also remove the shm segment (daemon, at shutdown).
int arena_close(int handle, int unlink_seg) {
  Arena* a = get_arena(handle);
  if (!a) return -1;
  munmap(a->base, a->capacity);
  if (unlink_seg) shm_unlink(a->name.c_str());
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_arenas[handle] = nullptr;
  }
  delete a;
  return 0;
}

}  // extern "C"
