// libdlrtpu: native runtime helpers for the TPU framework.
//
// Equivalent capability: the reference's native runtime pieces —
// atorch/dev/xpu_timer (C++ LD_PRELOAD profiler exporting GEMM/collective
// timings via a shared ring) and the C++/CUDA copy/quantization kernels
// under atorch/atorch/ops/csrc/. TPU redesign: the checkpoint hot path is
// an HBM->host-shm scatter copy (engine._write_shm_locked) and its restore
// counterpart, a shm->host gather copy; doing them here with a thread pool
// releases the GIL and saturates host memory bandwidth. The timing ring is
// the xpu_timer analogue: training processes push (tag, start, duration)
// records into a shared-memory ring; the agent drains and exports them.
// Streaming shard CRCs use zlib on the Python side (its slice-by-N crc32
// beats a byte-at-a-time C loop by ~5x); this file adds what zlib's
// Python module lacks — crc32_combine and a combine-based parallel crc —
// plus a threaded page prefault for fresh shm segments (the cold-save
// page-fault tax).
//
// Build: g++ -O3 -shared -fPIC -pthread -o libdlrtpu.so dlrtpu.cc
// (driven by dlrover_tpu/native/__init__.py, with a pure-Python fallback).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- copy

struct CopySeg {
  const char* src;
  uint64_t dst_offset;
  uint64_t size;
};

// Copy n segments into dst using up to nthreads threads. Large segments
// are split into 8 MiB chunks so threads balance regardless of segment
// size distribution.
void dlrtpu_scatter_copy(char* dst, const CopySeg* segs, uint64_t n,
                         int nthreads) {
  if (n == 0) return;
  constexpr uint64_t kChunk = 8ull << 20;
  struct Chunk {
    const char* src;
    char* dst;
    uint64_t size;
  };
  std::vector<Chunk> chunks;
  chunks.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t off = 0;
    while (off < segs[i].size) {
      uint64_t sz = segs[i].size - off;
      if (sz > kChunk) sz = kChunk;
      chunks.push_back(
          {segs[i].src + off, dst + segs[i].dst_offset + off, sz});
      off += sz;
    }
  }
  if (nthreads < 1) nthreads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((uint64_t)nthreads > chunks.size()) nthreads = (int)chunks.size();
  if (nthreads <= 1) {
    for (const auto& c : chunks) std::memcpy(c.dst, c.src, c.size);
    return;
  }
  std::atomic<uint64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= chunks.size()) return;
      std::memcpy(chunks[i].dst, chunks[i].src, chunks[i].size);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// The gather counterpart (restore hot path): copy n segments OUT of one
// big source buffer (shm segment / pinned read arena) into scattered
// destination arrays. Same chunking/thread-pool shape as scatter_copy.
struct GatherSeg {
  char* dst;
  uint64_t src_offset;
  uint64_t size;
};

void dlrtpu_gather_copy(const char* src, const GatherSeg* segs, uint64_t n,
                        int nthreads) {
  if (n == 0) return;
  constexpr uint64_t kChunk = 8ull << 20;
  struct Chunk {
    const char* src;
    char* dst;
    uint64_t size;
  };
  std::vector<Chunk> chunks;
  chunks.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t off = 0;
    while (off < segs[i].size) {
      uint64_t sz = segs[i].size - off;
      if (sz > kChunk) sz = kChunk;
      chunks.push_back(
          {src + segs[i].src_offset + off, segs[i].dst + off, sz});
      off += sz;
    }
  }
  if (nthreads < 1) nthreads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((uint64_t)nthreads > chunks.size()) nthreads = (int)chunks.size();
  if (nthreads <= 1) {
    for (const auto& c : chunks) std::memcpy(c.dst, c.src, c.size);
    return;
  }
  std::atomic<uint64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= chunks.size()) return;
      std::memcpy(chunks[i].dst, chunks[i].src, chunks[i].size);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// Touch-write one byte per page so a FRESH mapping (new shm segment,
// grown arena) faults its pages in across threads instead of inside the
// first single-threaded memcpy — the cold-save page-fault tax, paid in
// parallel. Caller contract: the buffer's current contents are garbage
// (it zeroes the first byte of every page).
void dlrtpu_prefault(char* buf, uint64_t len, int nthreads) {
  constexpr uint64_t kPage = 4096;
  if (len == 0) return;
  uint64_t pages = (len + kPage - 1) / kPage;
  if (nthreads < 1) nthreads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((uint64_t)nthreads > pages) nthreads = (int)pages;
  std::atomic<uint64_t> next{0};
  constexpr uint64_t kBatch = 256;  // pages per grab (1 MiB strides)
  auto worker = [&]() {
    for (;;) {
      uint64_t start = next.fetch_add(kBatch, std::memory_order_relaxed);
      if (start >= pages) return;
      uint64_t stop = start + kBatch;
      if (stop > pages) stop = pages;
      for (uint64_t p = start; p < stop; ++p) buf[p * kPage] = 0;
    }
  };
  if (nthreads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// ----------------------------------------------------------------- crc32
//
// zlib-compatible CRC-32 (reflected poly 0xEDB88320), slice-by-8, plus
// the GF(2) combine that lets independent chunk CRCs merge — the piece
// the Python zlib module lacks. Streaming restores checksum each chunk
// as it lands (seed chaining); the parallel variant fans a large
// in-memory payload across threads and combines, so the persist path's
// pre-write CRC runs at aggregate memory bandwidth.

static uint32_t crc_tab[8][256];
static std::once_flag crc_once;

static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_tab[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      crc_tab[t][i] =
          (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
}

uint32_t dlrtpu_crc32(const unsigned char* p, uint64_t len, uint32_t seed) {
  std::call_once(crc_once, crc_init);
  uint32_t c = seed ^ 0xFFFFFFFFu;
  while (len && ((uintptr_t)p & 7)) {
    c = crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    --len;
  }
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = crc_tab[7][c & 0xFF] ^ crc_tab[6][(c >> 8) & 0xFF] ^
        crc_tab[5][(c >> 16) & 0xFF] ^ crc_tab[4][c >> 24] ^
        crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
        crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) c = crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// zlib's crc32_combine: crc(A+B) from crc(A), crc(B), len(B).
static uint32_t gf2_matrix_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  while (vec) {
    if (vec & 1) sum ^= *mat;
    vec >>= 1;
    ++mat;
  }
  return sum;
}

static void gf2_matrix_square(uint32_t* square, const uint32_t* mat) {
  for (int n = 0; n < 32; ++n) square[n] = gf2_matrix_times(mat, mat[n]);
}

uint32_t dlrtpu_crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  uint32_t even[32], odd[32];
  if (len2 == 0) return crc1;
  odd[0] = 0xEDB88320u;  // CRC-32 polynomial, reflected
  uint32_t row = 1;
  for (int n = 1; n < 32; ++n) {
    odd[n] = row;
    row <<= 1;
  }
  gf2_matrix_square(even, odd);  // even = odd^2: shift by 2 zero bits
  gf2_matrix_square(odd, even);  // odd = even^2: shift by 4 zero bits
  do {
    gf2_matrix_square(even, odd);
    if (len2 & 1) crc1 = gf2_matrix_times(even, crc1);
    len2 >>= 1;
    if (len2 == 0) break;
    gf2_matrix_square(odd, even);
    if (len2 & 1) crc1 = gf2_matrix_times(odd, crc1);
    len2 >>= 1;
  } while (len2 != 0);
  return crc1 ^ crc2;
}

uint32_t dlrtpu_crc32_parallel(const unsigned char* p, uint64_t len,
                               uint32_t seed, int nthreads) {
  std::call_once(crc_once, crc_init);
  constexpr uint64_t kMinChunk = 8ull << 20;  // below this, threads lose
  if (nthreads < 1) nthreads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((uint64_t)nthreads > len / kMinChunk)
    nthreads = (int)(len / kMinChunk);
  if (nthreads <= 1) return dlrtpu_crc32(p, len, seed);
  uint64_t chunk = len / nthreads;
  std::vector<uint32_t> crcs(nthreads);
  std::vector<uint64_t> lens(nthreads);
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = t * chunk;
    uint64_t stop = (t == nthreads - 1) ? len : start + chunk;
    lens[t] = stop - start;
    pool.emplace_back([&, t, start]() {
      crcs[t] = dlrtpu_crc32(p + start, lens[t], t == 0 ? seed : 0);
    });
  }
  for (auto& th : pool) th.join();
  uint32_t crc = crcs[0];
  for (int t = 1; t < nthreads; ++t)
    crc = dlrtpu_crc32_combine(crc, crcs[t], lens[t]);
  return crc;
}

// ---------------------------------------------------------- timing ring

// Layout in caller-provided (shared) memory:
//   [0]  uint64 capacity (records)
//   [8]  atomic uint64 head (monotonic record count; slot reservation)
//   [16] Record[capacity]
//
// Each record carries a seqlock word: a writer reserves global index i
// via head.fetch_add, marks the slot "writing" (seq = 2i+1), writes the
// fields, then commits (seq = 2i+2, release). A reader accepts a slot
// only when seq == 2i+2 before AND after copying the fields, so torn or
// in-progress records are never returned.
struct Record {
  uint64_t tag;
  uint64_t start_ns;
  uint64_t dur_ns;
  std::atomic<uint64_t> seq;
};

struct RingHeader {
  uint64_t capacity;
  std::atomic<uint64_t> head;
};

uint64_t dlrtpu_ring_bytes(uint64_t capacity) {
  return sizeof(RingHeader) + capacity * sizeof(Record);
}

void dlrtpu_ring_init(void* buf, uint64_t capacity) {
  auto* h = reinterpret_cast<RingHeader*>(buf);
  auto* recs = reinterpret_cast<Record*>(
      reinterpret_cast<char*>(buf) + sizeof(RingHeader));
  h->capacity = capacity;
  for (uint64_t i = 0; i < capacity; ++i)
    recs[i].seq.store(0, std::memory_order_relaxed);
  h->head.store(0, std::memory_order_release);
}

void dlrtpu_ring_push(void* buf, uint64_t tag, uint64_t start_ns,
                      uint64_t dur_ns) {
  auto* h = reinterpret_cast<RingHeader*>(buf);
  auto* recs = reinterpret_cast<Record*>(
      reinterpret_cast<char*>(buf) + sizeof(RingHeader));
  uint64_t i = h->head.fetch_add(1, std::memory_order_acq_rel);
  Record& r = recs[i % h->capacity];
  r.seq.store(2 * i + 1, std::memory_order_release);  // writing
  r.tag = tag;
  r.start_ns = start_ns;
  r.dur_ns = dur_ns;
  r.seq.store(2 * i + 2, std::memory_order_release);  // committed
}

// Copy committed records in [*cursor, head) into out (up to max).
// Advances *cursor. Slots overwritten by a later lap are skipped; slots
// not yet committed stop the drain (they'll be picked up next time).
uint64_t dlrtpu_ring_drain(void* buf, Record* out, uint64_t max,
                           uint64_t* cursor) {
  auto* h = reinterpret_cast<RingHeader*>(buf);
  auto* recs = reinterpret_cast<Record*>(
      reinterpret_cast<char*>(buf) + sizeof(RingHeader));
  uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t cur = *cursor;
  if (head > cur + h->capacity) cur = head - h->capacity;  // lost records
  uint64_t n = 0;
  while (cur < head && n < max) {
    Record& slot = recs[cur % h->capacity];
    uint64_t want = 2 * cur + 2;
    uint64_t s1 = slot.seq.load(std::memory_order_acquire);
    if (s1 < want) break;      // reserved/writing, not committed yet
    if (s1 > want) {           // overwritten by a later lap
      ++cur;
      continue;
    }
    out[n].tag = slot.tag;
    out[n].start_ns = slot.start_ns;
    out[n].dur_ns = slot.dur_ns;
    uint64_t s2 = slot.seq.load(std::memory_order_acquire);
    if (s2 != want) {          // overwritten mid-copy: discard
      ++cur;
      continue;
    }
    out[n].seq.store(want, std::memory_order_relaxed);
    ++n;
    ++cur;
  }
  *cursor = cur;
  return n;
}

}  // extern "C"
