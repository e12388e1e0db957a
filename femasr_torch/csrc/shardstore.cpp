// FMRS shard store: one mmap'd file of raw uint8 images, and a threaded
// sampler of augmented training batches (random crop, flips, transpose)
// that writes an NHWC uint8 batch into a caller's buffer.
//
// The same file format, C API and random draws as the JAX package's
// femasr_tpu/native/shardstore.cpp, so either package reads the other's
// shards and draws the same batches for the same seed.
//
// File layout (little-endian):
//   magic "FMRS1\0\0\0" (8 bytes)
//   u64 n_items
//   n_items * { u64 offset; u32 h; u32 w; u32 c; u32 flags; char key[64]; }
//   blob data (raw uint8 HWC)
//
// C API (ctypes): fmrs_open / fmrs_close / fmrs_count / fmrs_meta /
//   fmrs_read / fmrs_sample_batch.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <atomic>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[8] = {'F', 'M', 'R', 'S', '1', 0, 0, 0};

#pragma pack(push, 1)
struct IndexEntry {
  uint64_t offset;
  uint32_t h, w, c, flags;
  char key[64];
};
#pragma pack(pop)

struct Store {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_items = 0;
  const IndexEntry* index = nullptr;
};

// xorshift128+ per-thread RNG: deterministic given the seed
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ull + 1;
    s1 = (seed ^ 0xBF58476D1CE4E5B9ull) | 1;
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  uint32_t below(uint32_t n) { return n ? (uint32_t)(next() % n) : 0; }
};

}  // namespace

extern "C" {

void* fmrs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<uint8_t*>(base);
  s->size = st.st_size;
  if (s->size < 16 || memcmp(s->base, kMagic, 8) != 0) {
    munmap(base, st.st_size); ::close(fd); delete s; return nullptr;
  }
  memcpy(&s->n_items, s->base + 8, 8);
  // bounds-validate the whole index against the mapping: a truncated or
  // corrupt shard must fail open() cleanly, not SIGSEGV on first access.
  // All checks are written in overflow-safe form (division / subtraction
  // against already-validated bounds) so a corrupt header with huge
  // n_items/offset cannot wrap uint64 arithmetic and slip past.
  if (s->n_items > ((uint64_t)s->size - 16) / sizeof(IndexEntry)) {
    munmap(base, st.st_size); ::close(fd); delete s; return nullptr;
  }
  uint64_t index_end = 16 + s->n_items * (uint64_t)sizeof(IndexEntry);
  s->index = reinterpret_cast<const IndexEntry*>(s->base + 16);
  for (uint64_t i = 0; i < s->n_items; ++i) {
    const IndexEntry& e = s->index[i];
    // h*w*c can overflow only if h,w,c are near 2^32; bound them first so
    // the product fits (2^21)^3 < 2^63.
    if (e.h > (1u << 21) || e.w > (1u << 21) || e.c > 16) {
      munmap(base, st.st_size); ::close(fd); delete s; return nullptr;
    }
    uint64_t nbytes = (uint64_t)e.h * e.w * e.c;
    if (e.offset < index_end || e.offset > (uint64_t)s->size ||
        nbytes > (uint64_t)s->size - e.offset) {
      munmap(base, st.st_size); ::close(fd); delete s; return nullptr;
    }
  }
  return s;
}

void fmrs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(s->base, s->size);
  ::close(s->fd);
  delete s;
}

uint64_t fmrs_count(void* handle) {
  return static_cast<Store*>(handle)->n_items;
}

// meta_out: [h, w, c]; key_out: 64 bytes
int fmrs_meta(void* handle, uint64_t idx, uint32_t* meta_out, char* key_out) {
  auto* s = static_cast<Store*>(handle);
  if (idx >= s->n_items) return -1;
  const IndexEntry& e = s->index[idx];
  meta_out[0] = e.h; meta_out[1] = e.w; meta_out[2] = e.c;
  if (key_out) memcpy(key_out, e.key, 64);
  return 0;
}

// copy the full raw image (h*w*c bytes) into out
int fmrs_read(void* handle, uint64_t idx, uint8_t* out) {
  auto* s = static_cast<Store*>(handle);
  if (idx >= s->n_items) return -1;
  const IndexEntry& e = s->index[idx];
  memcpy(out, s->base + e.offset, (size_t)e.h * e.w * e.c);
  return 0;
}

// Sample an augmented training batch:
//   indices[b]  item ids
//   crop        output crop size (0 => full image, all must be same size)
//   hflip/vflip/rot90: 1 to enable the random augmentation
//   seed        RNG seed (deterministic batches given seed)
//   out         (batch, crop, crop, 3) uint8 NHWC
int fmrs_sample_batch(void* handle, const uint64_t* indices, int batch,
                      int crop, int hflip, int vflip, int rot90,
                      uint64_t seed, int num_threads, uint8_t* out) {
  auto* s = static_cast<Store*>(handle);
  std::atomic<int> err{0};
  std::atomic<int> next{0};
  if (num_threads < 1) num_threads = 1;

  auto work = [&]() {
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= batch) return;
      uint64_t idx = indices[b];
      if (idx >= s->n_items) { err.store(-1); return; }
      const IndexEntry& e = s->index[idx];
      if (e.c != 3) { err.store(-2); return; }
      int ch = crop > 0 ? crop : (int)e.h;
      int cw = crop > 0 ? crop : (int)e.w;
      if ((int)e.h < ch || (int)e.w < cw) { err.store(-3); return; }
      Rng rng(seed * 0x100000001B3ull + idx * 1315423911ull + b);
      int top = rng.below(e.h - ch + 1);
      int left = rng.below(e.w - cw + 1);
      bool fh = hflip && (rng.next() & 1);
      bool fv = vflip && (rng.next() & 1);
      bool r90 = rot90 && (rng.next() & 1);
      const uint8_t* src = s->base + e.offset;
      uint8_t* dst = out + (size_t)b * ch * cw * 3;
      for (int y = 0; y < ch; ++y) {
        int sy = fv ? (top + ch - 1 - y) : (top + y);
        const uint8_t* row = src + ((size_t)sy * e.w + left) * 3;
        for (int x = 0; x < cw; ++x) {
          int sx = fh ? (cw - 1 - x) : x;
          const uint8_t* px = row + (size_t)sx * 3;
          uint8_t* q = r90 ? dst + ((size_t)x * cw + y) * 3
                           : dst + ((size_t)y * cw + x) * 3;
          q[0] = px[0]; q[1] = px[1]; q[2] = px[2];
        }
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads - 1; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
