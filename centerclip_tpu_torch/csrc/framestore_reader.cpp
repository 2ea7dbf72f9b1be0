// framestore_reader.cpp — native batch reader for the FrameStore container.
//
// The port's own copy of the JAX package's native/framestore_reader.cpp,
// built for the host by ops/_build.py (c++ -O3 -std=c++17 -fPIC -shared
// -pthread) at first use.  It replaces the reference's per-sample PyAV decode
// workers (reference: dataloaders/decode.py + torch DataLoader processes):
// instead of decoding video per sample in Python, pre-decoded frames are
// mmap'd and this reader performs the hot host-side path — frame gather,
// center-crop, uint8->float32 conversion and CLIP normalization — in C++ with
// a thread pool, writing the final fixed-shape [B, T, 3, size, size] batch
// directly into caller-provided memory (a pinned buffer, when the loader
// pins), with no Python-side copies and no GIL.
//
// File format: see data/framestore.py.
//   header : 'FST1' | u32 version | u64 num_entries | u64 index_off
//   data   : raw uint8 frames [T, H, W, C] per entry
//   index  : u16 key_len | key | u32 T,H,W,C | u64 offset
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <vector>
#include <thread>
#include <atomic>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  uint32_t t, h, w, c;
  uint64_t offset;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<Entry> entries;
  std::unordered_map<std::string, int64_t> by_key;
};

#pragma pack(push, 1)
struct Header {
  char magic[4];
  uint32_t version;
  uint64_t num_entries;
  uint64_t index_off;
};
#pragma pack(pop)

}  // namespace

extern "C" {

void* fs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;

  // Every read below stays inside the file: a truncated or corrupt store is
  // refused (nullptr) instead of read past its end.
  auto refuse = [&]() -> void* {
    munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  };
  const uint64_t size = static_cast<uint64_t>(st.st_size);
  Header hdr;
  if (size < sizeof(hdr)) return refuse();
  std::memcpy(&hdr, s->base, sizeof(hdr));
  if (std::memcmp(hdr.magic, "FST1", 4) != 0 || hdr.version != 1 ||
      hdr.index_off < sizeof(hdr) || hdr.index_off > size) {
    return refuse();
  }
  uint64_t pos = hdr.index_off;
  const uint64_t fixed = 4 * 4 + 8;
  for (uint64_t i = 0; i < hdr.num_entries; ++i) {
    uint16_t klen;
    if (size - pos < 2) return refuse();
    std::memcpy(&klen, s->base + pos, 2);
    pos += 2;
    if (size - pos < klen + fixed) return refuse();
    std::string key(reinterpret_cast<const char*>(s->base + pos), klen);
    pos += klen;
    const uint8_t* p = s->base + pos;
    Entry e;
    std::memcpy(&e.t, p, 4);  p += 4;
    std::memcpy(&e.h, p, 4);  p += 4;
    std::memcpy(&e.w, p, 4);  p += 4;
    std::memcpy(&e.c, p, 4);  p += 4;
    std::memcpy(&e.offset, p, 8);
    pos += fixed;
    const uint64_t bytes = (uint64_t)e.t * e.h * e.w * e.c;
    if (e.offset < sizeof(hdr) || e.offset > hdr.index_off ||
        bytes > hdr.index_off - e.offset) {
      return refuse();
    }
    s->by_key.emplace(std::move(key), static_cast<int64_t>(s->entries.size()));
    s->entries.push_back(e);
  }
  return s;
}

void fs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

int64_t fs_num_entries(void* handle) {
  return static_cast<Store*>(handle)->entries.size();
}

int64_t fs_find_key(void* handle, const char* key) {
  auto* s = static_cast<Store*>(handle);
  auto it = s->by_key.find(key);
  return it == s->by_key.end() ? -1 : it->second;
}

// Fills thwc[0..3] with the entry's (T, H, W, C).
int fs_entry_info(void* handle, int64_t entry_id, int64_t* thwc) {
  auto* s = static_cast<Store*>(handle);
  if (entry_id < 0 || entry_id >= (int64_t)s->entries.size()) return -1;
  const Entry& e = s->entries[entry_id];
  thwc[0] = e.t; thwc[1] = e.h; thwc[2] = e.w; thwc[3] = e.c;
  return 0;
}

// Gather + center-crop + normalize a batch.
//   entry_ids     [B]      framestore entry per sample
//   frame_indices [B, T]   frame index per (sample, slot); pre-clamped
//   out           [B, T, 3, size, size] float32 (CHW per frame)
//   mean, std     [3]      normalization stats (applied after /255)
// Frames smaller than `size` are zero-padded around the center, matching
// the Python transform (data/transforms.py center_crop).
int fs_gather_batch(void* handle, const int64_t* entry_ids,
                    const int64_t* frame_indices, int64_t B, int64_t T,
                    int64_t size, const float* mean, const float* stdv,
                    float* out, int num_threads) {
  auto* s = static_cast<Store*>(handle);
  const int64_t frame_elems = 3 * size * size;
  const int64_t sample_elems = T * frame_elems;
  float inv_std[3], norm_mean[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.0f / stdv[c];
    norm_mean[c] = mean[c];
  }
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    while (true) {
      int64_t b = next.fetch_add(1);
      if (b >= B) return;
      int64_t eid = entry_ids[b];
      if (eid < 0 || eid >= (int64_t)s->entries.size()) { err = 1; return; }
      const Entry& e = s->entries[eid];
      if (e.c != 3) { err = 2; return; }
      if (e.t == 0) { err = 3; return; }  // no frame to clamp to
      const int64_t H = e.h, W = e.w;
      // crop window in source coordinates (can be negative -> pad)
      const int64_t top = (H - size) / 2;
      const int64_t left = (W - size) / 2;
      for (int64_t t = 0; t < T; ++t) {
        int64_t fi = frame_indices[b * T + t];
        if (fi < 0) fi = 0;
        if (fi >= (int64_t)e.t) fi = e.t - 1;
        const uint8_t* frame = s->base + e.offset + (uint64_t)fi * H * W * 3;
        float* dst = out + b * sample_elems + t * frame_elems;
        for (int64_t y = 0; y < size; ++y) {
          const int64_t sy = top + y;
          const bool row_ok = sy >= 0 && sy < H;
          for (int c = 0; c < 3; ++c) {
            float* drow = dst + (int64_t)c * size * size + y * size;
            const float m = norm_mean[c], is = inv_std[c];
            // zero-PIXEL padding is applied before normalization in the
            // Python pipeline, so padded outputs are (0 - mean) / std
            const float pad = (0.0f - m) * is;
            if (!row_ok) {
              for (int64_t x = 0; x < size; ++x) drow[x] = pad;
              continue;
            }
            const uint8_t* srow = frame + sy * W * 3;
            for (int64_t x = 0; x < size; ++x) {
              const int64_t sx = left + x;
              if (sx < 0 || sx >= W) {
                drow[x] = pad;
              } else {
                drow[x] = ((float)srow[sx * 3 + c] * (1.0f / 255.0f) - m) * is;
              }
            }
          }
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// uint8 crop-only gather: out [B, T, 3, size, size] uint8 (CHW), zero pad.
// Pairs with on-device normalization (models/clip4clip.py uint8 path) —
// ships 4x fewer bytes to the accelerator than the float path.
int fs_gather_batch_u8(void* handle, const int64_t* entry_ids,
                       const int64_t* frame_indices, int64_t B, int64_t T,
                       int64_t size, uint8_t* out, int num_threads) {
  auto* s = static_cast<Store*>(handle);
  const int64_t frame_elems = 3 * size * size;
  const int64_t sample_elems = T * frame_elems;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    while (true) {
      int64_t b = next.fetch_add(1);
      if (b >= B) return;
      int64_t eid = entry_ids[b];
      if (eid < 0 || eid >= (int64_t)s->entries.size()) { err = 1; return; }
      const Entry& e = s->entries[eid];
      if (e.c != 3) { err = 2; return; }
      if (e.t == 0) { err = 3; return; }  // no frame to clamp to
      const int64_t H = e.h, W = e.w;
      const int64_t top = (H - size) / 2;
      const int64_t left = (W - size) / 2;
      for (int64_t t = 0; t < T; ++t) {
        int64_t fi = frame_indices[b * T + t];
        if (fi < 0) fi = 0;
        if (fi >= (int64_t)e.t) fi = e.t - 1;
        const uint8_t* frame = s->base + e.offset + (uint64_t)fi * H * W * 3;
        uint8_t* dst = out + b * sample_elems + t * frame_elems;
        for (int64_t y = 0; y < size; ++y) {
          const int64_t sy = top + y;
          const bool row_ok = sy >= 0 && sy < H;
          for (int c = 0; c < 3; ++c) {
            uint8_t* drow = dst + (int64_t)c * size * size + y * size;
            if (!row_ok) {
              std::memset(drow, 0, size);
              continue;
            }
            const uint8_t* srow = frame + sy * W * 3;
            for (int64_t x = 0; x < size; ++x) {
              const int64_t sx = left + x;
              drow[x] = (sx < 0 || sx >= W) ? 0 : srow[sx * 3 + c];
            }
          }
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

}  // extern "C"
