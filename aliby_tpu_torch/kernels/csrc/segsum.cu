// Per-bin reductions for Hopper (sm_90a): batched sums, min/max and the
// per-pixel lookup of a small per-bin table, and the unbatched per-label sums.
//
// binned_sum_cols replaces aliby_tpu/ops/pallas_segsum.py
// binned_sum_cols_batched (_sum_kernel): (B, N, K) f32 values and (B, N)
// int32 bins -> (B, n_bins, K) per-bin sums, K <= 32; bins outside
// [0, n_bins) add nothing. The TPU kernel multiplies a one-hot tile by the
// values on the MXU (in three bf16 pieces for f32 fidelity).
//
// segment_sum replaces pallas_segsum.py segment_sum_matmul (_kernel): the
// unbatched form, (N, K) f32 values and (N,) int32 labels -> (max_labels, K)
// per-label sums, K <= 32; label 0, negative labels and labels above
// max_labels add nothing. The TPU kernel accumulates onehot[P, L]^T @
// values[P, K] per 2048-pixel tile on the MXU. Here it is the sum kernel
// with B = 1 and bin = label - 1 (`shift` below), so a non-finite value
// reaches only its own label's sum, by IEEE addition (the matmul's 0 x inf
// made the whole column NaN for every label).
//
// Summation order, kept bit for bit from the port's first sum kernel: for
// every (image, bin, column) a left fold with __fadd_rn from +0.0 over the
// bin's pixels of each CHUNK = 4096-pixel chunk, in pixel order; then a left
// fold from +0.0 of those chunk sums, in chunk order. The order depends on
// N, the bins and CHUNK only, not on K, on the other columns or on n_bins,
// so two runs give the same bits (the mask-QC test err > flow_threshold
// cannot flip), a column's bits do not depend on the columns beside it, and
// the CPU reproduces the kernel exactly (ops/segsum.py
// binned_sum_cols_batched_chunked: index_add_ per chunk, which adds in
// index order on the CPU). A chunk in which a bin has no pixel is skipped in
// the second fold: that changes no bit, because neither fold can make -0.0
// (a fold from +0.0 under round-to-nearest never yields -0.0), so the absent
// chunk's +0.0 is the identity (x + +0.0 == x for every x but -0.0; NaN
// stays NaN, +-inf stays +-inf). No float atomics anywhere.
//
// Design. The first kernel, a thread per bin that scanned every staged
// pixel of its chunk, did n_bins x N compares (17 scans of each chunk at the
// costes histogram's 16,705 bins), left the card idle at few bins (96
// threads a block at 65 bins, a dependent 4,096-step loop each), and wrote
// a dense partial of B x n_chunks x n_bins x K floats, almost all zeros
// (102.6 MB at 16,705 bins). Now the work follows the pixels:
//
// Pass 1 (chunk_runs_kernel; grid: chunks x images, 1024 threads, 4 pixels
// a thread). The block sorts its chunk's pixels by bin with a stable LSD
// radix sort, two bits a pass (a block scan of the four digit counts, then
// each pixel to its place), over as many bits as n_bins has; a dropped pixel
// takes bin n_bins and sorts last. Stability keeps each bin's pixels in
// pixel order: each bin is one run, in the summation order above. A block
// scan numbers the runs. The values are staged in sorted order, up to 12
// columns at a time (4,096 x 12 x 4 B of opt-in dynamic shared memory; the
// chunk's lines are prefetched into L2 during the sort), so that each
// (run, column) task folds a contiguous column, 32 values a step from
// 16-byte loads issued before the step's adds. Each run writes one row of K
// sums into the chunk's own region of min(4,096, n_bins) rows and counts
// itself in its (image, bin) with an integer atomic.
// Pass 2. alloc_kernel hands each non-empty (image, bin) a segment of
// `entries` of its count (warp-aggregated integer atomics; the segments may
// land in any order) and lists it; scatter_kernel puts each run's row index
// into its bin's segment (in any order). combine_kernel, a warp per listed
// bin, ranks the rows by chunk with a bitmap of the chunks (a prefix count
// of its bits), and folds the rows in that order, a lane per column. Bins
// that no pixel reaches keep the +0.0 of a memset. Every pass runs the same
// code whatever K, n_bins or the data: only the number of loop steps
// changes (column groups, radix passes, 1,024-chunk windows).
// Work: bit-length(n_bins) / 2 scan passes per chunk and N x K adds, never
// n_bins x N. Scratch (allocated by the wrapper, ops/segsum.py
// sum_scratch_sizes), with rows = B x n_chunks x min(4,096, n_bins), at
// most B x (N + 4,095) and at most the first kernel's B x n_chunks x
// n_bins: rows x K floats, 2 x rows + B x n_chunks ints, 2 x B x n_bins + 2
// ints and min(B x n_bins, rows) int64. Bound on the H100: device-memory bytes (one read of the
// values and bins, one write of the sums). What bounds a block: the sort's
// barriers, the staging of each column group (device-memory bound across a
// wave of blocks) and the longest run's dependent add chain (up to 4,096
// adds at the add latency) once per group.
//
// binned_minmax replaces pallas_segsum.py binned_minmax_batched
// (_minmax_kernel): (B, N, K) f32 values, (B, N) int32 bins -> per-bin min
// and max of each column, each (B, n_bins, K); empty bins hold (+inf, -inf),
// bins outside [0, n_bins) are dropped, and a NaN value makes NaN in its own
// (bin, column) only. The TPU kernel masks a one-hot tile and reduces it on
// the vector unit. Floats are compared through an order-preserving int32 key
// (f2key: -0.0 just below +0.0), so shared atomicMin/atomicMax apply; a NaN
// takes the largest max key (INT32_MAX, above +inf's) and leaves the min key
// alone, and a max key above +inf's decodes to NaN in both outputs. Min and
// max do not depend on order, so the result is exact and the same bits on
// every run, whichever block finishes last.
// Design, one launch a call (binned_minmax_kernel; grid: G blocks per image
// x images, 256 threads, 4 blocks an SM). Each block walks tiles of kTile =
// 2,048 pixels of its image (tile g, g + G, ...); a thread takes 8
// consecutive pixels, issuing 16-byte loads of their bins and, at K = 1 and
// 2 (compiled apart; other K read a column at a time), of their values
// where the addresses allow, all before it uses any. It folds its pixels
// into runs of one bin in registers and updates the block's shared table of
// n_bins x K minimum and maximum keys once per run and column, with an
// atomic only where a plain read shows it can win: on label images
// (objects are contiguous, most pixels are background) that is one update
// for 8 pixels where the first kernel made one per pixel. Aggregating the
// runs across the warp first (__match_any_sync, or a reduction when every
// ending run of the warp is in one bin) was slower on the feature bank's
// label images than these per-lane updates, and far slower on uniform
// bins. Each block then writes its table to scratch; the last block of each
// image to finish (an integer ticket per image, which that block sets back
// to 0 for the next call) folds the G tables with
// 16-byte loads and writes the decoded minima and maxima. No init or
// decode launch and no memset. Scratch (allocated by the wrapper,
// ops/segsum.py minmax_scratch): B x G tables of 2 x n_bins x K keys, each
// rounded up to 16 bytes, with G chosen there to make one wave (4 blocks
// per SM) and to keep the last block's fold at most 65,536 keys a table.
// The tickets are the caller's: the wrapper keeps one zeroed array for each
// (device, stream), so calls on one stream run in order and calls on two
// streams count apart. Bound on the H100: device-memory bytes (one read of values and
// bins). At the feature bank's 16 x 256^2 pixels the loads alone run near
// that bound; the run updates and the chain that ends a call (tables,
// ticket, the last block's fold) take the rest. Shared memory: 2 x n_bins
// x K x 4 bytes, at most 32 KB.
//
// table_lookup replaces pallas_segsum.py table_lookup_batched
// (_lookup_kernel): (B, L, K) f32 table, (B, N) int32 bins -> (B, N, K)
// with out[p] = table[bins[p]]; a bin outside [0, L) gives 0 and a
// non-finite entry gives NaN (the TPU kernel's indicator rule, so +-inf
// becomes NaN). The TPU kernel is a one-hot matmul on the MXU. Here
// (table_lookup_kernel; grid: chunks of `chunk` pixels x images, 256
// threads) each block stages its image's table in shared memory (non-finite
// entries as NaN) and its chunk's bins (16-byte loads where aligned), then
// writes the chunk's chunk x K output floats as 16-byte stores, neighbouring
// threads on neighbouring addresses, with scalar stores only for the few
// floats before the first 16-byte boundary and after the last (an image
// whose output does not start on one: N x K not a multiple of 4). K = 1, 2,
// 3 and 5 (the widths the feature bank uses) are compiled apart, so the
// pixel of an output float is a division by a constant; one instance takes
// any other K. At a chunk of 1,024 pixels a 16-field call is 1,024 blocks,
// about 8 per SM. Bound on the H100: device-memory bytes (the bins read
// once, the output written once). Shared memory: (L x K + chunk) x 4 bytes,
// above 48 KB (L x K near 12,288) after an opt-in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int32_t kPosInfKey = 0x7f800000;  // key of +inf
constexpr int32_t kNegInfKey = (int32_t)0x807fffff;  // key of -inf

constexpr int kChunk = 4096;  // pixels per chunk: fixes the summation order
constexpr int kSumThreads = 1024;  // 4 pixels a thread
constexpr int kStage = 12;  // value columns staged in shared memory at most
constexpr int kValStride = kChunk + 4;  // floats per staged column (16-byte rows, spread banks)
// shared memory of chunk_runs_kernel: sorted bins, then the run starts
// (kValStride ints), sorted local indices (kChunk), the scans (128), the
// staged columns (kValStride floats each)
constexpr int kHeadBytes = (kValStride + kChunk + 128) * 4;
constexpr int kSumSmemMax = kHeadBytes + kStage * kValStride * 4;

// The scratch of the sum kernels; the wrapper allocates it (sizes in
// ops/segsum.py sum_scratch_sizes). A chunk has at most P = min(kChunk,
// n_bins) runs; row (b * n_chunks + c) * P + r holds run r of chunk c of
// image b.
struct SumScratch {
  float* run_sums;  // rows * K: each run's K chunk sums
  int32_t* run_bin;  // rows: each run's bin; the combine pass's ranked rows
  int32_t* entries;  // rows: the rows, bin by bin
  int32_t* run_count;  // B * n_chunks: runs per chunk
  int32_t* counters;  // 2 + B * n_bins: rows handed out, bins listed, then
                      // each bin's run count, turned into its cursor
  int32_t* offsets;  // B * n_bins: each listed bin's segment of entries
  int64_t* listed;  // min(B * n_bins, B * N): the non-empty (image, bin)s
};

// Columns [k0, k0 + gc) of the chunk's n_valid sorted pixels into s_val,
// column g at s_val[g * kValStride + j] for sorted position j.
__device__ __forceinline__ void stage_sorted(const float* __restrict__ v, int K, int k0, int gc,
                                             int n_valid, const int32_t* s_idx, float* s_val) {
  const int total = n_valid * gc;
  const int step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * step) {
    float x[8];
    int at[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step, j = e / gc, g = e - j * gc;
      at[u] = e < total ? g * kValStride + j : -1;
      x[u] = e < total ? v[(int64_t)s_idx[j] * K + k0 + g] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (at[u] >= 0) s_val[at[u]] = x[u];
  }
}

__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}

// The left fold from +0.0 of col[j0 .. j1): 32 values a step from eight
// 16-byte loads issued before the step's adds.
__device__ __forceinline__ float fold(const float* col, int j0, int j1) {
  float acc = 0.0f;
  int j = j0;
  for (; j < j1 && (j & 3); ++j) acc = __fadd_rn(acc, col[j]);
  const float4* p = reinterpret_cast<const float4*>(col + j);
  const int nq = (j1 - j) >> 2;
  int q = 0;
  for (; q + 8 <= nq; q += 8) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = p[q + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = add4(acc, x[u]);
  }
  for (; q < nq; ++q) acc = add4(acc, p[q]);
  for (j += 4 * nq; j < j1; ++j) acc = __fadd_rn(acc, col[j]);
  return acc;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix of x over the block's threads (32 warps) and the total;
// s_scan holds 64 elements. Every thread must call; it ends past a barrier.
template <typename T>
__device__ __forceinline__ T block_exclusive_sum(T x, T* total, T* s_scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_sum(x, lane);
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) s_scan[32 + lane] = warp_inclusive_sum(s_scan[lane], lane);
  __syncthreads();
  *total = s_scan[63];
  return (warp ? s_scan[32 + warp - 1] : T(0)) + incl - x;
}

// Pass 1: a block per (chunk, image); blockDim.x == kSumThreads. A pixel's
// bin is bins[p] - shift; those outside [0, n_bins) are dropped.
__global__ void __launch_bounds__(kSumThreads)
chunk_runs_kernel(const float* __restrict__ vals, const int32_t* __restrict__ bins, int64_t N,
                  int K, int64_t n_bins, int shift, int n_chunks, int P, int G, SumScratch s) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the sorted bins; once the runs are found, the first sorted position of
  // each run (R + 1 entries)
  uint32_t* s_bin = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_start = reinterpret_cast<int32_t*>(smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + kValStride * 4);  // sorted local indices
  int32_t* s_scan = s_idx + kChunk;  // 128 ints, or 64 64-bit counters
  unsigned long long* s_scan64 = reinterpret_cast<unsigned long long*>(s_scan);
  float* s_val = reinterpret_cast<float*>(smem + kHeadBytes);

  const int b = blockIdx.y, c = blockIdx.x, tid = threadIdx.x;
  const int64_t start = (int64_t)c * kChunk;
  const int len = (int)(N - start < kChunk ? N - start : kChunk);
  const int64_t pix0 = (int64_t)b * N + start;  // this chunk's pixels
  const int64_t row0 = ((int64_t)b * n_chunks + c) * P;  // and its run rows
  const float* v = vals + pix0 * K;
  const int32_t* bb = bins + pix0;

  // bring the chunk's values towards L2 while the bins sort
  const char* vbytes = reinterpret_cast<const char*>(v);
  for (int64_t o = (int64_t)tid * 128; o < (int64_t)len * K * 4; o += (int64_t)blockDim.x * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(vbytes + o));

  // Stable LSD radix sort of the chunk by bin, two bits a pass (each digit's
  // pixels keep their order), over as many bits as n_bins has; a dropped
  // pixel's bin is n_bins, so it sorts last. Thread t holds positions
  // 4t .. 4t + 3 of the current order. The four digit counts of a pass ride
  // in one 64-bit word, 16 bits each (a count is at most 4,096).
  uint32_t bin[4];
  int32_t idx[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = 4 * tid + u;
    bin[u] = (uint32_t)n_bins;
    if (p < len) {
      const int64_t x = (int64_t)bb[p] - shift;
      if (x >= 0 && x < n_bins) bin[u] = (uint32_t)x;
    }
    idx[u] = p;
  }
  const int n_bits = 32 - __clz((uint32_t)n_bins);
  for (int bit = 0; bit < n_bits; bit += 2) {
    unsigned long long mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) mine += 1ull << (16 * ((bin[u] >> bit) & 3));
    unsigned long long total;
    unsigned long long before = block_exclusive_sum(mine, &total, s_scan64);
    // each digit's first place: the counts of the digits below it
    const unsigned long long base = (total << 16) + (total << 32) + (total << 48);
    before += base;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int shift16 = 16 * ((bin[u] >> bit) & 3);
      const int dst = (int)((before >> shift16) & 0xffff);
      before += 1ull << shift16;
      s_bin[dst] = bin[u];
      s_idx[dst] = idx[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bin[u] = s_bin[4 * tid + u];
      idx[u] = s_idx[4 * tid + u];
    }
  }

  // run heads; a pixel is valid when its bin is below n_bins
  const int j0 = tid * 4;
  uint32_t prev = j0 ? s_bin[j0 - 1] : (uint32_t)n_bins;
  int heads = 0, n_valid = 0;
  bool head[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool valid = bin[u] < (uint32_t)n_bins;
    head[u] = valid && (j0 + u == 0 || prev != bin[u]);
    heads += head[u];
    n_valid += valid;
    prev = bin[u];
  }
  int R, n_valid_all;
  int r = block_exclusive_sum(heads, &R, s_scan);  // past a barrier: s_bin may be overwritten
  block_exclusive_sum(n_valid, &n_valid_all, s_scan + 64);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (head[u]) {
      s_start[r] = j0 + u;
      s.run_bin[row0 + r] = (int32_t)bin[u];
      atomicAdd(&s.counters[2 + (int64_t)b * n_bins + bin[u]], 1);
      ++r;
    }
  }
  if (tid == 0) {
    s_start[R] = n_valid_all;
    s.run_count[(int64_t)b * n_chunks + c] = R;
  }
  __syncthreads();

  // each (run, column) task folds its run in sorted (= pixel) order
  for (int k0 = 0; k0 < K; k0 += G) {
    const int gc = K - k0 < G ? K - k0 : G;
    if (k0) __syncthreads();
    stage_sorted(v, K, k0, gc, n_valid_all, s_idx, s_val);
    __syncthreads();
    for (int t = tid; t < R * gc; t += blockDim.x) {
      const int run = t / gc, g = t - run * gc;
      s.run_sums[(row0 + run) * K + k0 + g] =
          fold(s_val + g * kValStride, s_start[run], s_start[run + 1]);
    }
  }
}

// Pass 2a: a segment of `entries` for each non-empty (image, bin), and the
// list of those bins. A warp's bins take consecutive segments.
__global__ void alloc_kernel(SumScratch s, int64_t n_cells) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane; i0 < n_cells;
       i0 += stride) {
    const int64_t i = i0 + lane;
    const int n = i < n_cells ? s.counters[2 + i] : 0;
    const int incl = warp_inclusive_sum(n, lane);
    const unsigned busy = __ballot_sync(0xffffffffu, n > 0);
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0, lbase = 0;
    if (lane == 0 && busy) {
      base = atomicAdd(&s.counters[0], total);
      lbase = atomicAdd(&s.counters[1], __popc(busy));
    }
    base = __shfl_sync(0xffffffffu, base, 0);
    lbase = __shfl_sync(0xffffffffu, lbase, 0);
    if (n > 0) {
      const int off = base + incl - n;
      s.offsets[i] = off;
      s.counters[2 + i] = off;  // the scatter's cursor
      s.listed[lbase + __popc(busy & ((1u << lane) - 1u))] = i;
    }
  }
}

// Pass 2b: each run's row into its bin's segment, in any order.
__global__ void scatter_kernel(SumScratch s, int64_t n_bins, int n_chunks, int P) {
  const int b = blockIdx.y, c = blockIdx.x;
  const int R = s.run_count[(int64_t)b * n_chunks + c];
  const int64_t row0 = ((int64_t)b * n_chunks + c) * P;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int64_t cell = (int64_t)b * n_bins + s.run_bin[row0 + r];
    const int pos = atomicAdd(&s.counters[2 + cell], 1);
    s.entries[pos] = (int32_t)(row0 + r);
  }
}

// Pass 2c: a warp per listed (image, bin); blockDim.x == kCombineThreads.
// A row's chunk is row / P - b * n_chunks; the chunks of a bin's rows are
// distinct, and a row's rank among them is its place in the second fold.
// The ranks come from a bitmap of the chunks, 1,024 chunks a window (a
// word a lane), and a prefix count of its bits. Lane k folds column k.
constexpr int kCombineThreads = 64;

__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(SumScratch s, float* __restrict__ out, int K, int64_t n_bins, int n_chunks,
               int P) {
  __shared__ uint32_t s_bits[kCombineThreads];
  __shared__ int32_t s_before[kCombineThreads];
  const int lane = threadIdx.x & 31, w_in = threadIdx.x & ~31;
  uint32_t* bits = s_bits + w_in;
  int32_t* word_before = s_before + w_in;
  const int n_listed = s.counters[1];
  const int64_t nw = ((int64_t)gridDim.x * blockDim.x) >> 5;
  int32_t* ranked = s.run_bin;  // free once the scatter has read it
  for (int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < n_listed;
       w += nw) {
    const int64_t cell = s.listed[w];
    const int64_t chunk0 = cell / n_bins * n_chunks;  // the image's first chunk
    const int off = s.offsets[cell];
    const int m = s.counters[2 + cell] - off;
    const int32_t* e = s.entries + off;
    int done = 0;  // rows in earlier windows
    for (int c0 = 0; c0 < n_chunks; c0 += 1024) {
      bits[lane] = 0;
      __syncwarp();
      for (int a = lane; a < m; a += 32) {
        const int c = (int)(e[a] / P - chunk0) - c0;
        if (c >= 0 && c < 1024) atomicOr(&bits[c >> 5], 1u << (c & 31));
      }
      __syncwarp();
      const int n = __popc(bits[lane]);
      const int incl = warp_inclusive_sum(n, lane);
      word_before[lane] = incl - n;
      __syncwarp();
      for (int a = lane; a < m; a += 32) {
        const int32_t row = e[a];
        const int c = (int)(row / P - chunk0) - c0;
        if (c >= 0 && c < 1024)
          ranked[off + done + word_before[c >> 5] + __popc(bits[c >> 5] & ((1u << (c & 31)) - 1u))] =
              row;
      }
      done += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
    }
    float acc = 0.0f;
    for (int r0 = 0; r0 < m; r0 += 32) {
      const int32_t row = r0 + lane < m ? ranked[off + r0 + lane] : 0;
      const int n = m - r0 < 32 ? m - r0 : 32;
      int u = 0;
      if (n == 32) {  // a full tile: its 32 loads in flight at once
        float x[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const int32_t rt = __shfl_sync(0xffffffffu, row, t);
          x[t] = lane < K ? s.run_sums[(int64_t)rt * K + lane] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) acc = __fadd_rn(acc, x[t]);
        u = 32;
      }
      for (; u < n; ++u) {
        const int32_t rt = __shfl_sync(0xffffffffu, row, u);
        if (lane < K) acc = __fadd_rn(acc, s.run_sums[(int64_t)rt * K + lane]);
      }
    }
    if (lane < K) out[cell * K + lane] = acc;
    __syncwarp();
  }
}

// Order-preserving int32 key of an f32 (not NaN): a < b <=> key(a) < key(b),
// with -0.0 just below +0.0.
__device__ __forceinline__ int32_t f2key(float f) {
  const int32_t i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key2f(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

constexpr int32_t kNanKey = INT32_MAX;  // max key of NaN: above every other key
constexpr int kMinmaxThreads = 256;
constexpr int kPx = 8;  // consecutive pixels a thread takes at a time
constexpr int kTile = kPx * kMinmaxThreads;  // pixels a block takes at a time

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Folds columns k0 .. k0 + NC - 1 of a thread's kPx pixels (x[u * NC + c])
// into the block's tables s_tab (minima, then maxima at + slots): runs of
// one bin in registers, and at each pixel that ends a run, one update of
// the table per run and column, an atomic only where a plain read shows it
// can win.
template <int NC>
__device__ __forceinline__ void fold_runs(const int (&bin)[kPx], const float (&x)[kPx * NC],
                                          int k0, int K, int slots, int32_t* s_tab) {
  int32_t run_mn[NC], run_mx[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) run_mn[c] = kPosInfKey, run_mx[c] = kNegInfKey;
#pragma unroll
  for (int u = 0; u < kPx; ++u) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float f = x[u * NC + c];
      const bool nan = f != f;
      const int32_t key = f2key(f);
      run_mn[c] = min(run_mn[c], nan ? kPosInfKey : key);
      run_mx[c] = max(run_mx[c], nan ? kNanKey : key);
    }
    const bool ends = bin[u] >= 0 && (u == kPx - 1 || bin[u + 1] != bin[u]);
    if (ends) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int slot = bin[u] * K + k0 + c;
        if (run_mn[c] < s_tab[slot]) atomicMin(&s_tab[slot], run_mn[c]);
        if (run_mx[c] > s_tab[slots + slot]) atomicMax(&s_tab[slots + slot], run_mx[c]);
      }
    }
    if (ends || bin[u] < 0) {  // a new run starts at the next pixel
#pragma unroll
      for (int c = 0; c < NC; ++c) run_mn[c] = kPosInfKey, run_mx[c] = kNegInfKey;
    }
  }
}

// KT = K for K = 1 and 2 (all columns folded together, the pixels' values
// read 16 bytes at a time where aligned); KT = 0 takes any K (K_rt), a
// column at a time. Dynamic shared memory: 2 * n_bins * K int32. part: B *
// G tables of C = round_up(2 * n_bins * K, 4) keys, the minima, then the
// maxima, then padding.
template <int KT>
__global__ void __launch_bounds__(kMinmaxThreads, 4)
binned_minmax_kernel(const float* __restrict__ vals, const int32_t* __restrict__ bins,
                     float* __restrict__ mn_out, float* __restrict__ mx_out,
                     int32_t* __restrict__ part, unsigned int* __restrict__ tickets, int64_t N,
                     int K_rt, int n_bins, int G) {
  extern __shared__ int32_t s_tab[];
  __shared__ bool s_last;
  const int K = KT ? KT : K_rt;
  const int slots = n_bins * K;
  const int tid = threadIdx.x;
  for (int i = tid; i < slots; i += blockDim.x) {
    s_tab[i] = kPosInfKey;
    s_tab[slots + i] = kNegInfKey;
  }
  __syncthreads();

  const int b = blockIdx.y;
  const float* v = vals + (int64_t)b * N * K;
  const int32_t* bb = bins + (int64_t)b * N;
  const bool vec_bins = aligned16(bb);
  const bool vec_vals = KT && aligned16(v);
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < N; t0 += (int64_t)G * kTile) {
    const int64_t p0 = t0 + kPx * tid;
    const bool full = p0 + kPx <= N;
    // the bins and (K = 1, 2) the values of the thread's pixels, every load
    // issued before any is used
    constexpr int NC = KT ? KT : 1;
    int bin[kPx];
    float x[kPx * NC];
    if (vec_bins && full) {
      const int4* q = reinterpret_cast<const int4*>(bb + p0);
#pragma unroll
      for (int i = 0; i < kPx / 4; ++i) {
        const int4 w = q[i];
        bin[4 * i] = w.x, bin[4 * i + 1] = w.y, bin[4 * i + 2] = w.z, bin[4 * i + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPx; ++u) bin[u] = p0 + u < N ? bb[p0 + u] : -1;
    }
    if (KT && vec_vals && full) {
      const float4* q = reinterpret_cast<const float4*>(v + p0 * NC);
#pragma unroll
      for (int i = 0; i < kPx * NC / 4; ++i) {
        const float4 f = q[i];
        x[4 * i] = f.x, x[4 * i + 1] = f.y, x[4 * i + 2] = f.z, x[4 * i + 3] = f.w;
      }
    } else if (KT) {
#pragma unroll
      for (int i = 0; i < kPx * NC; ++i) x[i] = p0 + i / NC < N ? v[p0 * NC + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPx; ++u)
      if ((unsigned)bin[u] >= (unsigned)n_bins) bin[u] = -1;  // dropped
    if (KT) {
      fold_runs<NC>(bin, x, 0, NC, slots, s_tab);
    } else {
      for (int k = 0; k < K; ++k) {
        float xk[kPx];
#pragma unroll
        for (int u = 0; u < kPx; ++u) xk[u] = p0 + u < N ? v[(p0 + u) * K + k] : 0.0f;
        fold_runs<1>(bin, xk, k, K, slots, s_tab);
      }
    }
  }
  __syncthreads();

  // this block's table to scratch; the last block of the image to finish
  // folds the G tables into its own and writes the result
  const int C = (2 * slots + 3) & ~3;
  int32_t* pb = part + (int64_t)b * G * C;
  for (int i = tid; i < 2 * slots; i += blockDim.x) pb[(int64_t)blockIdx.x * C + i] = s_tab[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[b], 1u) == (unsigned)G - 1;
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) tickets[b] = 0;  // every block of the image has counted itself
  const int4* p4 = reinterpret_cast<const int4*>(pb);
  const int total = G * C / 4;  // G * C < 2^31: G <= 65,535, C <= 8,196
  for (int q0 = tid; q0 < total; q0 += 8 * blockDim.x) {
    int4 w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int q = q0 + r * blockDim.x;
      if (q < total) w[r] = __ldcg(p4 + q);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int q = q0 + r * blockDim.x;
      if (q >= total) break;
      const int j0 = 4 * q % C;
      const int32_t key[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        if (j < slots) {
          if (key[c] < s_tab[j]) atomicMin(&s_tab[j], key[c]);
        } else if (j < 2 * slots && key[c] > s_tab[j]) {
          atomicMax(&s_tab[j], key[c]);
        }
      }
    }
  }
  __syncthreads();
  const float qnan = __int_as_float(0x7fc00000);
  for (int i = tid; i < slots; i += blockDim.x) {
    const int32_t mx = s_tab[slots + i];
    const bool nan = mx > kPosInfKey;
    mn_out[(int64_t)b * slots + i] = nan ? qnan : key2f(s_tab[i]);
    mx_out[(int64_t)b * slots + i] = nan ? qnan : key2f(mx);
  }
}

// KT = K for the widths the feature bank uses; KT = 0 takes any K (K_rt).
// Dynamic shared memory: L * K floats, then `chunk` ints.
template <int KT>
__global__ void __launch_bounds__(256)
table_lookup_kernel(const float* __restrict__ table, const int32_t* __restrict__ bins,
                    float* __restrict__ out, int64_t N, int L, int K_rt, int chunk) {
  extern __shared__ __align__(16) float s_row[];
  const int K = KT ? KT : K_rt;
  int32_t* s_bin = reinterpret_cast<int32_t*>(s_row + L * K);
  const int b = blockIdx.y, tid = threadIdx.x;
  const float qnan = __int_as_float(0x7fc00000);
  const float* t = table + (int64_t)b * L * K;
  for (int i = tid; i < L * K; i += blockDim.x) {
    const float x = t[i];
    s_row[i] = isfinite(x) ? x : qnan;
  }
  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int len = (int)(N - start < chunk ? N - start : chunk);
  const int32_t* bb = bins + (int64_t)b * N + start;
  int p = 0;
  if (aligned16(bb)) {
    const int4* q = reinterpret_cast<const int4*>(bb);
    for (int i = tid; i < len / 4; i += blockDim.x) {
      const int4 w = q[i];
      s_bin[4 * i] = w.x, s_bin[4 * i + 1] = w.y, s_bin[4 * i + 2] = w.z, s_bin[4 * i + 3] = w.w;
    }
    p = len & ~3;
  }
  for (int i = p + tid; i < len; i += blockDim.x) s_bin[i] = bb[i];
  __syncthreads();

  // output float e of the chunk: pixel e / K, column e % K
  auto at = [&](int e) {
    const int px = e / K, bin = s_bin[px];
    return (unsigned)bin < (unsigned)L ? s_row[bin * K + (e - px * K)] : 0.0f;
  };
  float* o = out + ((int64_t)b * N + start) * K;
  const int n = len * K;
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4, n);
  if (tid < head) o[tid] = at(tid);
  const int nq = (n - head) / 4;
  float4* o4 = reinterpret_cast<float4*>(o + head);
#pragma unroll 4
  for (int q = tid; q < nq; q += blockDim.x) {
    const int e = head + 4 * q;
    o4[q] = make_float4(at(e), at(e + 1), at(e + 2), at(e + 3));
  }
  for (int e = head + 4 * nq + tid; e < n; e += blockDim.x) o[e] = at(e);
}

int grid_for(int64_t total) {
  int64_t blocks = (total + 255) / 256;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

// The sum kernels' launches on one stream. With rows = B * n_chunks * P,
// P = min(kChunk, n_bins): `ints` holds, in order, the counters
// (2 + B * n_bins), the offsets (B * n_bins), the run counts (B * n_chunks),
// the run bins (rows) and the entries (rows); `run_sums` rows * K floats;
// `listed` min(B * n_bins, rows) int64; `out` B * n_bins * K.
int sum_runs(const float* vals, const int32_t* bins, int shift, float* run_sums, int32_t* ints,
             int64_t* listed, float* out, int B, int64_t N, int K, int64_t n_bins,
             void* stream) {
  if (B < 1 || N < 1 || K < 1 || K > kMaxK || n_bins < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + kChunk - 1) / kChunk;
  const int P = n_bins < kChunk ? (int)n_bins : kChunk;
  const int64_t rows = (int64_t)B * n_chunks * P;
  if (rows >= INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t cells = (int64_t)B * n_bins;
  cudaStream_t st = (cudaStream_t)stream;
  SumScratch s;
  s.run_sums = run_sums;
  s.counters = ints;
  s.offsets = ints + 2 + cells;
  s.run_count = s.offsets + cells;
  s.run_bin = s.run_count + B * n_chunks;
  s.entries = s.run_bin + rows;
  s.listed = listed;
  // the attribute is the current device's: set once on each card (a
  // device past the table's 64 sets it on every call)
  static bool smem_opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !smem_opted_in[dev])) {
    e = cudaFuncSetAttribute(chunk_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSumSmemMax);
    if (e == cudaSuccess && dev < 64) smem_opted_in[dev] = true;
  }
  if (e == cudaSuccess) e = cudaMemsetAsync(ints, 0, (size_t)(2 + cells) * sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(out, 0, (size_t)cells * K * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  // the columns in groups of at most kStage, as even as they come
  const int n_groups = (K + kStage - 1) / kStage;
  const int G = (K + n_groups - 1) / n_groups;
  const size_t smem = (size_t)kHeadBytes + (size_t)kValStride * G * sizeof(float);
  const dim3 grid((unsigned)n_chunks, B);
  chunk_runs_kernel<<<grid, kSumThreads, smem, st>>>(vals, bins, N, K, n_bins, shift,
                                                     (int)n_chunks, P, G, s);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  alloc_kernel<<<grid_for(cells), 256, 0, st>>>(s, cells);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_kernel<<<grid, 256, 0, st>>>(s, n_bins, (int)n_chunks, P);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t most_listed = cells < rows ? cells : rows;
  // two warps a block, so that few long lists still spread over the SMs
  const int64_t combine_blocks = (most_listed + 1) / 2;
  combine_kernel<<<combine_blocks < 8192 ? (int)combine_blocks : 8192, kCombineThreads, 0, st>>>(
      s, out, K, n_bins, (int)n_chunks, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int binned_sum_cols(const float* vals, const int32_t* bins, float* run_sums,
                               int32_t* ints, int64_t* listed, float* out, int B, int64_t N,
                               int K, int64_t n_bins, void* stream) {
  return sum_runs(vals, bins, 0, run_sums, ints, listed, out, B, N, K, n_bins, stream);
}

// Labels 1..max_labels are bins 0..max_labels - 1 of one image.
extern "C" int segment_sum(const float* vals, const int32_t* labels, float* run_sums,
                           int32_t* ints, int64_t* listed, float* out, int64_t N, int K,
                           int64_t max_labels, void* stream) {
  return sum_runs(vals, labels, 1, run_sums, ints, listed, out, 1, N, K, max_labels, stream);
}

// mn and mx receive B * n_bins * K floats each; part holds B * G *
// round_up(2 * n_bins * K, 4) int32 of scratch, 16-byte aligned (G blocks
// per image, chosen by the wrapper); tickets B zeroed counters that no call
// on another stream uses at the same time (the kernel leaves them zero).
// One launch; 2 * n_bins * K * 4 bytes of shared memory (at most 32 KB).
extern "C" int binned_minmax(const float* vals, const int32_t* bins, float* mn, float* mx,
                             int32_t* part, unsigned int* tickets, int B, int64_t N, int K,
                             int n_bins, int64_t G, void* stream) {
  if (B < 1 || N < 1 || K < 1 || n_bins < 1 || G < 1 || G > 65535 || B > 65535 ||
      (int64_t)n_bins * K > 4096)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * n_bins * K * sizeof(int32_t);
  const dim3 grid((unsigned)G, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 1)
    binned_minmax_kernel<1><<<grid, kMinmaxThreads, smem, s>>>(vals, bins, mn, mx, part,
                                                               tickets, N, K, n_bins, (int)G);
  else if (K == 2)
    binned_minmax_kernel<2><<<grid, kMinmaxThreads, smem, s>>>(vals, bins, mn, mx, part,
                                                               tickets, N, K, n_bins, (int)G);
  else
    binned_minmax_kernel<0><<<grid, kMinmaxThreads, smem, s>>>(vals, bins, mn, mx, part,
                                                               tickets, N, K, n_bins, (int)G);
  return (int)cudaGetLastError();
}

namespace {

template <int KT>
cudaError_t launch_lookup(const float* table, const int32_t* bins, float* out, int B, int64_t N,
                          int L, int K, int chunk, cudaStream_t s) {
  const size_t smem = ((size_t)L * K + chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        table_lookup_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((N + chunk - 1) / chunk), B);
  table_lookup_kernel<KT><<<grid, 256, smem, s>>>(table, bins, out, N, L, K, chunk);
  return cudaGetLastError();
}

}  // namespace

// out holds B * N * K floats; `chunk` pixels a block, a multiple of 4 up to
// 4,096. (L * K + chunk) * 4 bytes of shared memory.
extern "C" int table_lookup(const float* table, const int32_t* bins, float* out, int B,
                            int64_t N, int L, int K, int chunk, void* stream) {
  if (B < 1 || N < 1 || L < 1 || K < 1 || chunk < 4 || chunk > 4096 || chunk % 4 ||
      B > 65535 || (int64_t)L * K > 12288)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (K) {
    case 1: e = launch_lookup<1>(table, bins, out, B, N, L, K, chunk, s); break;
    case 2: e = launch_lookup<2>(table, bins, out, B, N, L, K, chunk, s); break;
    case 3: e = launch_lookup<3>(table, bins, out, B, N, L, K, chunk, s); break;
    case 5: e = launch_lookup<5>(table, bins, out, B, N, L, K, chunk, s); break;
    default: e = launch_lookup<0>(table, bins, out, B, N, L, K, chunk, s);
  }
  return (int)e;
}
