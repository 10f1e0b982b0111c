// Per-bin reductions for Hopper (sm_90a): batched sums, min/max and the
// per-pixel lookup of a small per-bin table, and the unbatched per-label sums.
//
// binned_sum_cols replaces aliby_tpu/ops/pallas_segsum.py
// binned_sum_cols_batched (_sum_kernel): (B, N, K) f32 values and (B, N)
// int32 bins -> (B, n_bins, K) per-bin sums, K <= 32; bins outside
// [0, n_bins) add nothing. The TPU kernel multiplies a one-hot tile by the
// values on the MXU (in three bf16 pieces for f32 fidelity). Here the sums
// are plain f32 adds, and the result is deterministic: no atomics anywhere.
//
// Pass 1 (grid: pixel chunks x images): a block stages a tile of its chunk
// (bins and K values) in shared memory; each thread owns one bin and walks
// the staged pixels in order, adding the values whose bin is its own (a
// broadcast read of the shared bin for the whole warp). Its per-bin sums
// for the chunk go to a partial buffer. Pass 2 sums the partials of each
// (image, bin, column) over the chunks in chunk order. So every sum is taken
// in a fixed order, and two runs on the same input give the same bits (the
// mask-QC test err > flow_threshold cannot flip between runs). The order
// does not depend on K or on the staged tile's length, so a column's sum is
// the same bits whatever columns ride beside it. Counts stay exact below
// 2^24. Bound on the H100: device-memory bytes (one read of values and
// bins); the compares cost n_bins/blockDim passes over the staged pixels,
// which is why one block covers up to 1024 bins at once.
//
// segment_sum replaces pallas_segsum.py segment_sum_matmul (_kernel): the
// unbatched form, (N, K) f32 values and (N,) int32 labels -> (max_labels, K)
// per-label sums, K <= 32; label 0, negative labels and labels above
// max_labels add nothing. The TPU kernel accumulates onehot[P, L]^T @
// values[P, K] per 2048-pixel tile on the MXU, one grid step after another.
// Here the grid runs over the pixel chunks of the one array, in parallel:
// each thread owns one label (1..max_labels; there is no background row),
// walks its block's staged pixels in order (the same device code as pass 1
// above), and writes its chunk sums to a partial buffer that pass 2 adds in
// chunk order. No atomics: two runs give the same bits. A non-finite value
// reaches only its own label's sum, by IEEE addition (the matmul's 0 x inf
// made the whole column NaN for every label). Bound: device-memory bytes
// (one read of values and labels).
//
// binned_minmax replaces pallas_segsum.py binned_minmax_batched
// (_minmax_kernel): (B, N, K) f32 values, (B, N) int32 bins -> per-bin min
// and max of each column, each (B, n_bins, K); empty bins hold (+inf, -inf),
// bins outside [0, n_bins) are dropped, and a NaN value makes NaN in its own
// (bin, column) only. The TPU kernel masks a one-hot tile and reduces it on
// the vector unit. Here a block takes one image and one chunk of pixels and
// folds them into a shared-memory table of n_bins x K minima and maxima with
// shared atomicMin/atomicMax on an order-preserving int32 encoding of the
// float (a plain read first skips the atomic when the value cannot win);
// NaN sets a per-(bin, column) flag instead. The block tables merge into
// the output with global atomics on the same encoding. Min and max do not
// depend on order, so the result is exact and the same bits on every run.
// Bound: device-memory bytes (one read of values and bins).
//
// table_lookup replaces pallas_segsum.py table_lookup_batched
// (_lookup_kernel): (B, L, K) f32 table, (B, N) int32 bins -> (B, N, K)
// with out[p] = table[bins[p]]; a bin outside [0, L) gives 0 and a
// non-finite entry gives NaN (the TPU kernel's indicator rule, so +-inf
// becomes NaN). The TPU kernel is a one-hot matmul on the MXU; here each
// block stages its image's table in shared memory and its threads walk the
// output elements of a chunk of pixels in order, so loads of the bins and
// stores of the output are coalesced. Bound: device-memory bytes (the bins
// read once, the output written once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int32_t kPosInfKey = 0x7f800000;  // key of +inf
constexpr int32_t kNegInfKey = (int32_t)0x807fffff;  // key of -inf

// pixels staged in shared memory at a time: (K + 1) * stage * 4 <= 36 KB
inline int stage_for(int K) { return K <= 8 ? 1024 : (K <= 16 ? 512 : 256); }

// The sums of the pixels [start, end) whose bin is `mine`, K columns, taken
// in pixel order through a staged tile; every thread of the block must call.
template <int KB>
__device__ __forceinline__ void chunk_sums(const float* __restrict__ v,
                                           const int32_t* __restrict__ bb, int64_t start,
                                           int64_t end, int K, int mine, int stage,
                                           int32_t* s_bins, float* s_vals, float (&acc)[KB]) {
#pragma unroll
  for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
  for (int64_t t0 = start; t0 < end; t0 += stage) {
    const int len = (int)(end - t0 < stage ? end - t0 : stage);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) s_bins[i] = bb[t0 + i];
    for (int i = threadIdx.x; i < len * K; i += blockDim.x) s_vals[i] = v[t0 * K + i];
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      if (s_bins[i] == mine) {
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) acc[k] = __fadd_rn(acc[k], s_vals[i * K + k]);
      }
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(1024)
binned_sum_partial_kernel(const float* __restrict__ vals, const int32_t* __restrict__ bins,
                          float* __restrict__ partial, int64_t N, int K, int n_bins,
                          int64_t chunk, int n_chunks, int stage) {
  extern __shared__ unsigned char smem[];
  int32_t* s_bins = reinterpret_cast<int32_t*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_bins + stage);

  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int64_t start = (int64_t)c * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  const float* v = vals + (int64_t)b * N * K;
  const int32_t* bb = bins + (int64_t)b * N;

  for (int bin0 = 0; bin0 < n_bins; bin0 += blockDim.x) {
    const int mine = bin0 + threadIdx.x;
    float acc[KB];
    chunk_sums<KB>(v, bb, start, end, K, mine, stage, s_bins, s_vals, acc);
    if (mine < n_bins) {
      float* out = partial + (((int64_t)b * n_chunks + c) * n_bins + mine) * K;
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k < K) out[k] = acc[k];
    }
  }
}

// One array of N pixels; the grid runs over its chunks. Thread t of a pass
// owns label l0 + t + 1; row l - 1 of a chunk's partial block holds label l.
template <int KB>
__global__ void __launch_bounds__(1024)
segment_sum_partial_kernel(const float* __restrict__ vals, const int32_t* __restrict__ labels,
                           float* __restrict__ partial, int64_t N, int K, int max_labels,
                           int64_t chunk, int stage) {
  extern __shared__ unsigned char smem[];
  int32_t* s_bins = reinterpret_cast<int32_t*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_bins + stage);

  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  for (int l0 = 0; l0 < max_labels; l0 += blockDim.x) {
    const int mine = l0 + threadIdx.x + 1;
    float acc[KB];
    chunk_sums<KB>(vals, labels, start, end, K, mine, stage, s_bins, s_vals, acc);
    if (mine <= max_labels) {
      float* out = partial + ((int64_t)blockIdx.x * max_labels + (mine - 1)) * K;
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k < K) out[k] = acc[k];
    }
  }
}

__global__ void binned_sum_combine_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int B,
                                          int n_chunks, int n_bins, int K) {
  const int64_t per_image = (int64_t)n_bins * K;
  const int64_t total = (int64_t)B * per_image;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = idx / per_image;
    const int64_t r = idx % per_image;
    const float* p = partial + b * n_chunks * per_image + r;
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, p[(int64_t)c * per_image]);
    out[idx] = s;
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

__global__ void minmax_init_kernel(int32_t* __restrict__ mn, int32_t* __restrict__ mx,
                                   int32_t* __restrict__ nan, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    mn[i] = kPosInfKey;
    mx[i] = kNegInfKey;
    nan[i] = 0;
  }
}

__global__ void binned_minmax_kernel(const float* __restrict__ vals,
                                     const int32_t* __restrict__ bins,
                                     int32_t* __restrict__ mn, int32_t* __restrict__ mx,
                                     int32_t* __restrict__ nan, int64_t N, int K,
                                     int n_bins, int64_t chunk) {
  extern __shared__ int32_t s_tab[];
  const int T = n_bins * K;
  int32_t* s_min = s_tab;
  int32_t* s_max = s_tab + T;
  int32_t* s_nan = s_tab + 2 * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    s_min[i] = kPosInfKey;
    s_max[i] = kNegInfKey;
    s_nan[i] = 0;
  }
  __syncthreads();

  const int b = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  const float* v = vals + (int64_t)b * N * K;
  const int32_t* bb = bins + (int64_t)b * N;
  for (int64_t p = start + threadIdx.x; p < end; p += blockDim.x) {
    const int bin = bb[p];
    if (bin < 0 || bin >= n_bins) continue;
    for (int k = 0; k < K; ++k) {
      const float x = v[p * K + k];
      const int slot = bin * K + k;
      if (isnan(x)) {
        atomicOr(&s_nan[slot], 1);
        continue;
      }
      const int32_t key = f2key(x);
      if (key < s_min[slot]) atomicMin(&s_min[slot], key);
      if (key > s_max[slot]) atomicMax(&s_max[slot], key);
    }
  }
  __syncthreads();

  const int64_t base = (int64_t)b * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    if (s_min[i] != kPosInfKey) atomicMin(&mn[base + i], s_min[i]);
    if (s_max[i] != kNegInfKey) atomicMax(&mx[base + i], s_max[i]);
    if (s_nan[i]) atomicOr(&nan[base + i], 1);
  }
}

// Decode the keys in place: mn and mx then hold the f32 results.
__global__ void minmax_finish_kernel(int32_t* __restrict__ mn, int32_t* __restrict__ mx,
                                     const int32_t* __restrict__ nan, int64_t total) {
  const float qnan = __int_as_float(0x7fc00000);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool n = nan[i] != 0;
    reinterpret_cast<float*>(mn)[i] = n ? qnan : key2f(mn[i]);
    reinterpret_cast<float*>(mx)[i] = n ? qnan : key2f(mx[i]);
  }
}

__global__ void table_lookup_kernel(const float* __restrict__ table,
                                    const int32_t* __restrict__ bins,
                                    float* __restrict__ out, int64_t N, int L, int K,
                                    int chunk) {
  extern __shared__ float s_row[];
  const int b = blockIdx.y;
  const float qnan = __int_as_float(0x7fc00000);
  const float* t = table + (int64_t)b * L * K;
  for (int i = threadIdx.x; i < L * K; i += blockDim.x) {
    const float x = t[i];
    s_row[i] = isfinite(x) ? x : qnan;
  }
  __syncthreads();

  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  const int n_out = (int)(end - start) * K;
  const int32_t* bb = bins + (int64_t)b * N + start;
  float* o = out + ((int64_t)b * N + start) * K;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int p = e / K;
    const int bin = bb[p];
    o[e] = (bin >= 0 && bin < L) ? s_row[bin * K + (e - p * K)] : 0.0f;
  }
}

int grid_for(int64_t total) {
  int64_t blocks = (total + 255) / 256;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// partial must hold B * ceil(N / chunk) * n_bins * K floats.
extern "C" int binned_sum_cols(const float* vals, const int32_t* bins, float* partial,
                               float* out, int B, int64_t N, int K, int n_bins,
                               int64_t chunk, void* stream) {
  if (B < 1 || N < 1 || K < 1 || K > kMaxK || n_bins < 1 || chunk < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int stage = stage_for(K);
  const size_t smem = (size_t)stage * sizeof(int32_t) + (size_t)stage * K * sizeof(float);
  dim3 grid((unsigned)n_chunks, B);
  if (K <= 8)
    binned_sum_partial_kernel<8><<<grid, threads, smem, s>>>(
        vals, bins, partial, N, K, n_bins, chunk, (int)n_chunks, stage);
  else if (K <= 16)
    binned_sum_partial_kernel<16><<<grid, threads, smem, s>>>(
        vals, bins, partial, N, K, n_bins, chunk, (int)n_chunks, stage);
  else
    binned_sum_partial_kernel<32><<<grid, threads, smem, s>>>(
        vals, bins, partial, N, K, n_bins, chunk, (int)n_chunks, stage);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)B * n_bins * K;
  binned_sum_combine_kernel<<<grid_for(total), 256, 0, s>>>(partial, out, B, (int)n_chunks,
                                                           n_bins, K);
  return (int)cudaGetLastError();
}

// partial must hold ceil(N / chunk) * max_labels * K floats; out holds
// max_labels * K.
extern "C" int segment_sum(const float* vals, const int32_t* labels, float* partial,
                           float* out, int64_t N, int K, int max_labels, int64_t chunk,
                           void* stream) {
  if (N < 1 || K < 1 || K > kMaxK || max_labels < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int threads = ((max_labels + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int stage = stage_for(K);
  const size_t smem = (size_t)stage * sizeof(int32_t) + (size_t)stage * K * sizeof(float);
  const unsigned grid = (unsigned)n_chunks;
  if (K <= 8)
    segment_sum_partial_kernel<8><<<grid, threads, smem, s>>>(vals, labels, partial, N, K,
                                                             max_labels, chunk, stage);
  else if (K <= 16)
    segment_sum_partial_kernel<16><<<grid, threads, smem, s>>>(vals, labels, partial, N, K,
                                                              max_labels, chunk, stage);
  else
    segment_sum_partial_kernel<32><<<grid, threads, smem, s>>>(vals, labels, partial, N, K,
                                                              max_labels, chunk, stage);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)max_labels * K;
  binned_sum_combine_kernel<<<grid_for(total), 256, 0, s>>>(partial, out, 1, (int)n_chunks,
                                                           max_labels, K);
  return (int)cudaGetLastError();
}

// mn, mx and nan hold B * n_bins * K int32 each; on return mn and mx hold
// the f32 minima and maxima. 3 * n_bins * K * 4 bytes of shared memory must
// fit the default 48 KB (the wrapper checks).
extern "C" int binned_minmax(const float* vals, const int32_t* bins, int32_t* mn,
                             int32_t* mx, int32_t* nan, int B, int64_t N, int K,
                             int n_bins, int64_t chunk, void* stream) {
  if (B < 1 || N < 1 || K < 1 || n_bins < 1 || chunk < 1 || B > 65535 ||
      (int64_t)n_bins * K > 4096)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)B * n_bins * K;
  minmax_init_kernel<<<grid_for(total), 256, 0, s>>>(mn, mx, nan, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)3 * n_bins * K * sizeof(int32_t);
  dim3 grid((unsigned)n_chunks, B);
  binned_minmax_kernel<<<grid, 256, smem, s>>>(vals, bins, mn, mx, nan, N, K, n_bins, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  minmax_finish_kernel<<<grid_for(total), 256, 0, s>>>(mn, mx, nan, total);
  return (int)cudaGetLastError();
}

// out holds B * N * K floats. L * K * 4 bytes of shared memory must fit the
// default 48 KB (the wrapper checks).
extern "C" int table_lookup(const float* table, const int32_t* bins, float* out, int B,
                            int64_t N, int L, int K, int chunk, void* stream) {
  if (B < 1 || N < 1 || L < 1 || K < 1 || chunk < 1 || B > 65535 ||
      (int64_t)L * K > 12288 || (int64_t)chunk * K > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L * K * sizeof(float);
  dim3 grid((unsigned)n_chunks, B);
  table_lookup_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(table, bins, out, N, L, K,
                                                                chunk);
  return (int)cudaGetLastError();
}
