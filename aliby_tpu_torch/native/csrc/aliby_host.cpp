// aliby_tpu_torch native host runtime: threaded image decode + chunk codecs
// (the port's own copy of the JAX package's native/aliby_host.cpp).
//
// A baseline TIFF decoder (raw / LZW / PackBits / deflate, 8/16-bit,
// multi-page) and batched zlib inflate, both fanned out over a thread pool
// so frame prefetch overlaps device compute.
//
// Built with ALIBY_NO_ZLIB where the host has no <zlib.h>: the deflate case
// then returns the unsupported-compression code (-10), as for any other
// compression this decoder does not know, and aliby_inflate_batch returns -1.
//
// C ABI only (ctypes-friendly); no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#ifndef ALIBY_NO_ZLIB
#include <zlib.h>
#endif

namespace {

// ---------------------------------------------------------------- thread pool
class Pool {
 public:
  explicit Pool(int n) {
    if (n < 1) n = 1;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { this->loop(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> g(mu_);
      jobs_.push(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
  }
  void wait() {
    std::unique_lock<std::mutex> g(mu_);
    done_cv_.wait(g, [this] { return pending_ == 0; });
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
      {
        std::lock_guard<std::mutex> g(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_ = false;
  int pending_ = 0;
};

Pool* pool() {
  static Pool p(std::max(2u, std::thread::hardware_concurrency()));
  return &p;
}

// ------------------------------------------------------------------ TIFF core
struct Reader {
  const uint8_t* p;
  size_t n;
  bool le;
  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return le ? (uint16_t)(p[off] | p[off + 1] << 8)
              : (uint16_t)(p[off] << 8 | p[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return le ? ((uint32_t)p[off] | (uint32_t)p[off + 1] << 8 |
                 (uint32_t)p[off + 2] << 16 | (uint32_t)p[off + 3] << 24)
              : ((uint32_t)p[off] << 24 | (uint32_t)p[off + 1] << 16 |
                 (uint32_t)p[off + 2] << 8 | (uint32_t)p[off + 3]);
  }
};

struct Ifd {
  uint32_t width = 0, height = 0, bits = 8, compression = 1, spp = 1;
  uint32_t rows_per_strip = 0;
  std::vector<uint32_t> strip_offsets, strip_counts;
  bool ok = false;
};

// Read an IFD entry's values (SHORT or LONG arrays).
static std::vector<uint32_t> entry_values(const Reader& r, size_t entry) {
  uint16_t type = r.u16(entry + 2);
  uint32_t count = r.u32(entry + 4);
  std::vector<uint32_t> out;
  size_t vsize = (type == 3) ? 2 : 4;  // SHORT vs LONG
  if (type != 3 && type != 4) {
    out.push_back(r.u32(entry + 8));
    return out;
  }
  size_t src = (count * vsize <= 4) ? entry + 8 : r.u32(entry + 8);
  for (uint32_t i = 0; i < count; ++i)
    out.push_back(type == 3 ? (uint32_t)r.u16(src + i * vsize)
                            : r.u32(src + i * vsize));
  return out;
}

static Ifd parse_ifd(const Reader& r, size_t ifd_off) {
  Ifd ifd;
  uint16_t n_entries = r.u16(ifd_off);
  for (uint16_t i = 0; i < n_entries; ++i) {
    size_t e = ifd_off + 2 + i * 12;
    uint16_t tag = r.u16(e);
    auto vals = entry_values(r, e);
    if (vals.empty()) continue;
    switch (tag) {
      case 256: ifd.width = vals[0]; break;
      case 257: ifd.height = vals[0]; break;
      case 258: ifd.bits = vals[0]; break;
      case 259: ifd.compression = vals[0]; break;
      case 273: ifd.strip_offsets = vals; break;
      case 277: ifd.spp = vals[0]; break;
      case 278: ifd.rows_per_strip = vals[0]; break;
      case 279: ifd.strip_counts = vals; break;
      default: break;
    }
  }
  if (!ifd.rows_per_strip) ifd.rows_per_strip = ifd.height;
  ifd.ok = ifd.width && ifd.height && !ifd.strip_offsets.empty();
  return ifd;
}

// TIFF-variant LZW (early-change) decoder.
static bool lzw_decode(const uint8_t* src, size_t n, uint8_t* dst,
                       size_t dst_cap, size_t* written) {
  constexpr int kClear = 256, kEoi = 257;
  std::vector<std::vector<uint8_t>> table;
  auto reset = [&] {
    table.assign(258, {});
    for (int i = 0; i < 256; ++i) table[i] = {(uint8_t)i};
  };
  reset();
  int bits = 9;
  uint32_t acc = 0;
  int acc_bits = 0;
  size_t si = 0, di = 0;
  int prev = -1;
  while (si < n || acc_bits >= bits) {
    while (acc_bits < bits && si < n) {
      acc = (acc << 8) | src[si++];
      acc_bits += 8;
    }
    if (acc_bits < bits) break;
    int code = (acc >> (acc_bits - bits)) & ((1 << bits) - 1);
    acc_bits -= bits;
    if (code == kEoi) break;
    if (code == kClear) {
      reset();
      bits = 9;
      prev = -1;
      continue;
    }
    std::vector<uint8_t> entry;
    if (code < (int)table.size() && !table[code].empty())
      entry = table[code];
    else if (code == (int)table.size() && prev >= 0) {
      entry = table[prev];
      entry.push_back(table[prev][0]);
    } else if (code < 256) {
      entry = {(uint8_t)code};
    } else {
      return false;
    }
    if (di + entry.size() > dst_cap) return false;
    std::memcpy(dst + di, entry.data(), entry.size());
    di += entry.size();
    if (prev >= 0) {
      auto next = table[prev];
      next.push_back(entry[0]);
      table.push_back(std::move(next));
    }
    prev = code;
    // TIFF early change: grow one code early.
    if ((int)table.size() + 1 >= (1 << bits) && bits < 12) ++bits;
  }
  *written = di;
  return true;
}

static bool packbits_decode(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_cap, size_t* written) {
  size_t si = 0, di = 0;
  while (si < n) {
    int8_t h = (int8_t)src[si++];
    if (h >= 0) {
      size_t cnt = (size_t)h + 1;
      if (si + cnt > n || di + cnt > dst_cap) return false;
      std::memcpy(dst + di, src + si, cnt);
      si += cnt;
      di += cnt;
    } else if (h != -128) {
      size_t cnt = (size_t)(-h) + 1;
      if (si >= n || di + cnt > dst_cap) return false;
      std::memset(dst + di, src[si++], cnt);
      di += cnt;
    }
  }
  *written = di;
  return true;
}

static std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize((size_t)size);
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) buf.clear();
  std::fclose(f);
  return buf;
}

// Decode one TIFF page into out (row-major, native uint8/16). Returns 0 on
// success; fills width/height/bits.
static int decode_tiff_page(const uint8_t* data, size_t n, int page,
                            uint8_t* out, size_t out_cap, uint32_t* width,
                            uint32_t* height, uint32_t* bits) {
  if (n < 8) return -1;
  Reader r{data, n, data[0] == 'I'};
  if (!((data[0] == 'I' && data[1] == 'I') ||
        (data[0] == 'M' && data[1] == 'M')))
    return -1;
  if (r.u16(2) != 42) return -1;
  size_t ifd_off = r.u32(4);
  for (int i = 0; i < page && ifd_off; ++i) {
    uint16_t cnt = r.u16(ifd_off);
    ifd_off = r.u32(ifd_off + 2 + cnt * 12);
  }
  if (!ifd_off) return -2;  // page out of range
  Ifd ifd = parse_ifd(r, ifd_off);
  if (!ifd.ok) return -3;
  if (ifd.spp != 1) return -4;
  size_t bytes_px = ifd.bits / 8;
  size_t need = (size_t)ifd.width * ifd.height * bytes_px;
  if (need > out_cap) return -5;
  size_t row_bytes = (size_t)ifd.width * bytes_px;
  size_t di = 0;
  for (size_t s = 0; s < ifd.strip_offsets.size(); ++s) {
    size_t off = ifd.strip_offsets[s];
    size_t cnt = s < ifd.strip_counts.size() ? ifd.strip_counts[s]
                                             : need - di;
    if (off + cnt > n) return -6;
    size_t strip_rows =
        std::min((size_t)ifd.rows_per_strip,
                 (size_t)ifd.height - s * ifd.rows_per_strip);
    size_t strip_bytes = strip_rows * row_bytes;
    size_t written = 0;
    switch (ifd.compression) {
      case 1:
        if (di + cnt > need) cnt = need - di;
        std::memcpy(out + di, data + off, cnt);
        written = cnt;
        break;
      case 5:
        if (!lzw_decode(data + off, cnt, out + di, need - di, &written))
          return -7;
        break;
      case 32773:
        if (!packbits_decode(data + off, cnt, out + di, need - di, &written))
          return -8;
        break;
#ifndef ALIBY_NO_ZLIB
      case 8: {  // zlib/deflate
        uLongf dlen = (uLongf)(need - di);
        if (uncompress(out + di, &dlen, data + off, (uLong)cnt) != Z_OK)
          return -9;
        written = dlen;
        break;
      }
#endif
      default:
        return -10;  // unsupported compression
    }
    (void)strip_bytes;
    di += written;
  }
  // Byte-swap 16-bit big-endian to native little-endian.
  if (ifd.bits == 16 && !r.le) {
    for (size_t i = 0; i + 1 < need; i += 2) std::swap(out[i], out[i + 1]);
  }
  *width = ifd.width;
  *height = ifd.height;
  *bits = ifd.bits;
  return 0;
}

}  // namespace

extern "C" {

// Probe a TIFF: fills width/height/bits/pages. Returns 0 on success.
int aliby_tiff_info(const char* path, uint32_t* width, uint32_t* height,
                    uint32_t* bits, uint32_t* pages) {
  auto buf = read_file(path);
  if (buf.empty()) return -1;
  Reader r{buf.data(), buf.size(), buf[0] == 'I'};
  if (r.u16(2) != 42) return -1;
  size_t ifd_off = r.u32(4);
  uint32_t count = 0;
  Ifd first;
  while (ifd_off) {
    if (count == 0) first = parse_ifd(r, ifd_off);
    uint16_t cnt = r.u16(ifd_off);
    ifd_off = r.u32(ifd_off + 2 + cnt * 12);
    ++count;
    if (count > 65535) break;
  }
  if (!first.ok) return -3;
  *width = first.width;
  *height = first.height;
  *bits = first.bits;
  *pages = count;
  return 0;
}

// Decode one page of one file. out must hold width*height*(bits/8) bytes.
int aliby_tiff_decode(const char* path, int page, uint8_t* out,
                      uint64_t out_cap, uint32_t* width, uint32_t* height,
                      uint32_t* bits) {
  auto buf = read_file(path);
  if (buf.empty()) return -1;
  return decode_tiff_page(buf.data(), buf.size(), page, out, out_cap, width,
                          height, bits);
}

// Batch decode: n files (same shape) in parallel into one contiguous block.
// Returns 0 if every file decoded.
int aliby_tiff_decode_batch(const char** paths, const int* pages, int n,
                            uint8_t* out, uint64_t frame_bytes,
                            uint32_t* width, uint32_t* height,
                            uint32_t* bits) {
  std::vector<int> rc(n, 0);
  std::vector<uint32_t> w(n), h(n), b(n);
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      rc[i] = aliby_tiff_decode(paths[i], pages ? pages[i] : 0,
                                out + (uint64_t)i * frame_bytes, frame_bytes,
                                &w[i], &h[i], &b[i]);
    });
  }
  pool()->wait();
  for (int i = 0; i < n; ++i)
    if (rc[i] != 0) return rc[i];
  *width = w[0];
  *height = h[0];
  *bits = b[0];
  return 0;
}

// Batch zlib inflate (zarr chunks): n buffers in parallel.
int aliby_inflate_batch(const uint8_t** srcs, const uint64_t* src_lens, int n,
                        uint8_t* out, uint64_t chunk_bytes) {
#ifdef ALIBY_NO_ZLIB
  (void)srcs, (void)src_lens, (void)n, (void)out, (void)chunk_bytes;
  return -1;
#else
  std::vector<int> rc(n, 0);
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      uLongf dlen = (uLongf)chunk_bytes;
      rc[i] = uncompress(out + (uint64_t)i * chunk_bytes, &dlen, srcs[i],
                         (uLong)src_lens[i]) == Z_OK
                  ? 0
                  : -1;
    });
  }
  pool()->wait();
  for (int i = 0; i < n; ++i)
    if (rc[i]) return -1;
  return 0;
#endif
}

}  // extern "C"
