// Shared-memory object index: lock-free local object lookup.
//
// Analog of the plasma client's local object table
// (src/ray/object_manager/plasma/{store.h,client.h}): the store daemon
// (raylet) publishes every local object's (offset, size, sealed) into a
// fixed open-addressing hash table in its own shm segment; clients resolve
// `get` of local SEALED objects with two atomic loads and a pin — no RPC
// round-trip on the hottest path in ray.get.
//
// Concurrency protocol (single writer = daemon, many reader processes):
//   reader:  state==SEALED? -> readers.fetch_add -> re-check state+version
//            -> read payload -> readers.fetch_sub
//   daemon:  remove = state:=TOMBSTONE (no new pins) -> readers==0?
//            -> version++ -> slot reusable; else report busy and the
//            daemon defers the arena free until readers drains to 0.
// version is the ABA guard: a slot reused for a new object bumps it, so a
// stale release can never unpin someone else's object.
//
// Exposed as a plain C API for ctypes binding (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kKeySize = 28;  // ObjectID binary size
constexpr uint32_t kEmpty = 0;
constexpr uint32_t kPending = 1;
constexpr uint32_t kSealed = 2;
constexpr uint32_t kTombstone = 3;

// All cross-process-shared fields are atomics: the pin/version protocol makes
// stale reads harmless, but plain fields would still be formal data races
// (and TSAN reports) — payload reads are relaxed, ordered by the
// release-store of `state` (seal) / acquire-load on the reader side.
struct Slot {
  std::atomic<uint32_t> state;
  std::atomic<uint32_t> version;
  std::atomic<uint32_t> readers;
  uint32_t pad;
  std::atomic<uint64_t> offset;
  std::atomic<uint64_t> size;
  std::atomic<uint64_t> key0, key1, key2;  // 24 bytes of key
  std::atomic<uint32_t> key3;              // + 4 = kKeySize (28)
  uint32_t pad2;
};
static_assert(sizeof(Slot) == 64, "slot must be one cache line");
static_assert(std::atomic<uint64_t>::is_always_lock_free, "need lock-free u64");

struct Header {
  uint64_t magic;
  uint64_t nslots;
};
constexpr uint64_t kMagic = 0x7470755f69647831ULL;  // "tpu_idx1"

struct Index {
  std::string name;
  Header* hdr = nullptr;
  Slot* slots = nullptr;
  uint64_t nslots = 0;
  void* base = nullptr;
  uint64_t map_size = 0;
  bool owner = false;
};

std::mutex g_mu;
std::vector<Index*> g_indexes;

int register_index(Index* ix) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_indexes.push_back(ix);
  return static_cast<int>(g_indexes.size() - 1);
}

Index* get_index(int handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (handle < 0 || handle >= static_cast<int>(g_indexes.size())) return nullptr;
  return g_indexes[handle];
}

uint64_t fnv1a(const uint8_t* key) {
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kKeySize; ++i) {
    h ^= key[i];
    h *= 1099511628211ULL;
  }
  return h;
}

void key_split(const uint8_t* key, uint64_t& a, uint64_t& b, uint64_t& c, uint32_t& d) {
  std::memcpy(&a, key, 8);
  std::memcpy(&b, key + 8, 8);
  std::memcpy(&c, key + 16, 8);
  std::memcpy(&d, key + 24, 4);
}

bool key_eq(const Slot& s, const uint8_t* key) {
  uint64_t a, b, c;
  uint32_t d;
  key_split(key, a, b, c, d);
  return s.key0.load(std::memory_order_relaxed) == a &&
         s.key1.load(std::memory_order_relaxed) == b &&
         s.key2.load(std::memory_order_relaxed) == c &&
         s.key3.load(std::memory_order_relaxed) == d;
}

void key_store(Slot& s, const uint8_t* key) {
  uint64_t a, b, c;
  uint32_t d;
  key_split(key, a, b, c, d);
  s.key0.store(a, std::memory_order_relaxed);
  s.key1.store(b, std::memory_order_relaxed);
  s.key2.store(c, std::memory_order_relaxed);
  s.key3.store(d, std::memory_order_relaxed);
}

// Find the LIVE (pending/sealed) slot holding `key`, or nullptr. Probe stops
// at EMPTY; tombstoned slots are skipped for lookups (their key bytes remain
// only so draining releases can still be accounted — see idx_release, which
// addresses slots by index, not key).
Slot* find_live(Index* ix, const uint8_t* key) {
  uint64_t mask = ix->nslots - 1;
  uint64_t i = fnv1a(key) & mask;
  for (uint64_t probe = 0; probe < ix->nslots; ++probe, i = (i + 1) & mask) {
    Slot& s = ix->slots[i];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return nullptr;
    if ((st == kPending || st == kSealed) && key_eq(s, key)) return &s;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Create (daemon) or attach (client) the index segment. nslots rounded up to
// a power of two. Returns handle >= 0, or -1.
int idx_create(const char* name, uint64_t nslots) {
  uint64_t n = 1;
  while (n < nslots) n <<= 1;
  uint64_t size = sizeof(Header) + n * sizeof(Slot);
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -1;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return -1;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return -1;
  }
  std::memset(base, 0, size);
  Index* ix = new Index();
  ix->name = name;
  ix->base = base;
  ix->map_size = size;
  ix->hdr = static_cast<Header*>(base);
  ix->slots = reinterpret_cast<Slot*>(static_cast<uint8_t*>(base) + sizeof(Header));
  ix->nslots = n;
  ix->owner = true;
  ix->hdr->nslots = n;
  std::atomic_thread_fence(std::memory_order_release);
  ix->hdr->magic = kMagic;
  return register_index(ix);
}

int idx_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  uint64_t size = static_cast<uint64_t>(st.st_size);
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  Header* hdr = static_cast<Header*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, size);
    return -1;
  }
  Index* ix = new Index();
  ix->name = name;
  ix->base = base;
  ix->map_size = size;
  ix->hdr = hdr;
  ix->slots = reinterpret_cast<Slot*>(static_cast<uint8_t*>(base) + sizeof(Header));
  ix->nslots = hdr->nslots;
  ix->owner = false;
  return register_index(ix);
}

// Daemon: publish a created (not yet sealed) object. Returns 0, or -1 full.
int idx_put(int handle, const uint8_t* key, uint64_t offset, uint64_t size) {
  Index* ix = get_index(handle);
  if (!ix || !ix->owner) return -1;
  uint64_t mask = ix->nslots - 1;
  uint64_t i = fnv1a(key) & mask;
  Slot* target = nullptr;   // existing slot for this key (live, or drained tombstone)
  Slot* fallback = nullptr; // first reusable slot in the chain
  for (uint64_t probe = 0; probe < ix->nslots; ++probe, i = (i + 1) & mask) {
    Slot& s = ix->slots[i];
    uint32_t st = s.state.load(std::memory_order_relaxed);
    if (st == kEmpty) {
      if (!fallback) fallback = &s;
      break;  // end of probe chain
    }
    if (key_eq(s, key)) {
      if (st == kPending || st == kSealed) {
        // Re-create (idempotent). Refuse while pinned: bumping the version
        // under a live pin would orphan that reader's release. The pin
        // window must be CLOSED before the readers check (same store-load
        // seq_cst pairing as idx_remove): demote to kPending first so no
        // new pin can succeed its re-validation, then check readers — a
        // plain check while state stayed kSealed would race a concurrent
        // pin and hand that reader a torn offset/size pair mid-overwrite.
        s.state.store(kPending, std::memory_order_seq_cst);
        if (s.readers.load(std::memory_order_seq_cst) != 0) {
          s.state.store(st, std::memory_order_release);  // payload untouched
          return -1;
        }
        target = &s;
        break;
      }
      // Tombstoned same-key slot: reuse it ONLY once its readers drained —
      // a second slot for the same key would break pin accounting.
      if (s.readers.load(std::memory_order_acquire) == 0) {
        target = &s;
        break;
      }
      return -1;  // old entry still pinned; caller retries later
    }
    if (st == kTombstone && !fallback && s.readers.load(std::memory_order_acquire) == 0) {
      fallback = &s;
    }
  }
  if (!target) target = fallback;
  if (!target) return -1;
  // Order matters for concurrent readers: bump version first (invalidates
  // stale pins), write payload fields, then flip state last with release.
  target->version.fetch_add(1, std::memory_order_acq_rel);
  key_store(*target, key);
  target->offset.store(offset, std::memory_order_relaxed);
  target->size.store(size, std::memory_order_relaxed);
  target->state.store(kPending, std::memory_order_release);
  return 0;
}

// Daemon: mark sealed (payload fully written). Returns 0 or -1.
int idx_seal(int handle, const uint8_t* key) {
  Index* ix = get_index(handle);
  if (!ix || !ix->owner) return -1;
  Slot* s = find_live(ix, key);
  if (!s) return -1;
  s->state.store(kSealed, std::memory_order_release);
  return 0;
}

// Daemon: remove. Returns 0 = removed (safe to free arena block),
// 1 = tombstoned but readers still pinned (defer the free), -1 = not found.
int idx_remove(int handle, const uint8_t* key) {
  Index* ix = get_index(handle);
  if (!ix || !ix->owner) return -1;
  Slot* s = find_live(ix, key);
  if (!s) return -1;
  // seq_cst pair with the reader's pin (fetch_add; state re-check): without
  // it the daemon could miss a concurrent pin AND the reader could miss the
  // tombstone (store-load reordering), freeing memory under a reader.
  s->state.store(kTombstone, std::memory_order_seq_cst);
  if (s->readers.load(std::memory_order_seq_cst) == 0) return 0;
  return 1;
}

// Daemon: total readers pinning any slot of `key`, including drained
// tombstones in the probe chain (post-remove drain polling).
uint32_t idx_readers(int handle, const uint8_t* key) {
  Index* ix = get_index(handle);
  if (!ix) return 0;
  uint64_t mask = ix->nslots - 1;
  uint64_t i = fnv1a(key) & mask;
  uint32_t total = 0;
  for (uint64_t probe = 0; probe < ix->nslots; ++probe, i = (i + 1) & mask) {
    Slot& s = ix->slots[i];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) break;
    if (key_eq(s, key)) total += s.readers.load(std::memory_order_acquire);
  }
  return total;
}

// Client: resolve + pin a SEALED object. On hit returns 1 and fills
// (*offset, *size, *version, *slot); the caller MUST idx_release(slot,
// version). Returns 0 on miss (not local / not sealed / being deleted).
int idx_get_pinned(int handle, const uint8_t* key, uint64_t* offset,
                   uint64_t* size, uint32_t* version, uint64_t* slot) {
  Index* ix = get_index(handle);
  if (!ix) return 0;
  Slot* s = find_live(ix, key);
  if (!s) return 0;
  if (s->state.load(std::memory_order_acquire) != kSealed) return 0;
  uint32_t v = s->version.load(std::memory_order_acquire);
  s->readers.fetch_add(1, std::memory_order_seq_cst);
  // Re-validate under the pin (seq_cst pairs with idx_remove): the daemon
  // may have tombstoned or reused the slot between first check and pin.
  if (s->state.load(std::memory_order_seq_cst) != kSealed ||
      s->version.load(std::memory_order_acquire) != v || !key_eq(*s, key)) {
    s->readers.fetch_sub(1, std::memory_order_acq_rel);
    return 0;
  }
  *offset = s->offset.load(std::memory_order_relaxed);
  *size = s->size.load(std::memory_order_relaxed);
  *version = v;
  *slot = static_cast<uint64_t>(s - ix->slots);
  return 1;
}

// Client: release a pin taken by idx_get_pinned. Addressed by slot index so
// re-created keys (new slot or bumped version) can never absorb or drop a
// stale release.
int idx_release(int handle, uint64_t slot, uint32_t version) {
  Index* ix = get_index(handle);
  if (!ix || slot >= ix->nslots) return -1;
  Slot* s = &ix->slots[slot];
  if (s->version.load(std::memory_order_acquire) != version) return -1;
  s->readers.fetch_sub(1, std::memory_order_acq_rel);
  return 0;
}

int idx_close(int handle, int unlink_seg) {
  Index* ix = get_index(handle);
  if (!ix) return -1;
  munmap(ix->base, ix->map_size);
  if (unlink_seg) shm_unlink(ix->name.c_str());
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_indexes[handle] = nullptr;
  }
  delete ix;
  return 0;
}

}  // extern "C"
