// Batched per-bin column sums for Hopper (sm_90a).
//
// binned_sum_cols replaces aliby_tpu/ops/pallas_segsum.py
// binned_sum_cols_batched (_sum_kernel): (B, N, K) f32 values and (B, N)
// int32 bins -> (B, n_bins, K) per-bin sums; bins outside [0, n_bins) add
// nothing. The TPU kernel multiplies a one-hot tile by the values on the
// MXU (in three bf16 pieces for f32 fidelity). Here the sums are plain f32
// adds, and the result is deterministic: no atomics anywhere.
//
// Pass 1 (grid: pixel chunks x images): a block stages 1024 pixels of its
// chunk (bins and K values) in shared memory; each thread owns one bin and
// walks the staged pixels in order, adding the values whose bin is its own
// (a broadcast read of the shared bin for the whole warp). Its per-bin sums
// for the chunk go to a partial buffer. Pass 2 sums the partials of each
// (image, bin, column) over the chunks in chunk order. So every sum is taken
// in a fixed order, and two runs on the same input give the same bits (the
// mask-QC test err > flow_threshold cannot flip between runs). Counts stay
// exact below 2^24. Bound on the H100: device-memory bytes (one read of
// values and bins); the compares cost n_bins/blockDim passes over the
// staged pixels, which is why one block covers up to 1024 bins at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 1024;  // pixels staged in shared memory at a time
constexpr int kMaxK = 8;

__global__ void binned_sum_partial_kernel(const float* __restrict__ vals,
                                          const int32_t* __restrict__ bins,
                                          float* __restrict__ partial, int64_t N,
                                          int K, int n_bins, int64_t chunk,
                                          int n_chunks) {
  extern __shared__ unsigned char smem[];
  int32_t* s_bins = reinterpret_cast<int32_t*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_bins + kStage);

  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int64_t start = (int64_t)c * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  const float* v = vals + (int64_t)b * N * K;
  const int32_t* bb = bins + (int64_t)b * N;

  for (int bin0 = 0; bin0 < n_bins; bin0 += blockDim.x) {
    const int mine = bin0 + threadIdx.x;
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0f;
    for (int64_t t0 = start; t0 < end; t0 += kStage) {
      const int len = (int)(end - t0 < kStage ? end - t0 : kStage);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += blockDim.x) s_bins[i] = bb[t0 + i];
      for (int i = threadIdx.x; i < len * K; i += blockDim.x) s_vals[i] = v[t0 * K + i];
      __syncthreads();
      for (int i = 0; i < len; ++i) {
        if (s_bins[i] == mine) {
#pragma unroll
          for (int k = 0; k < kMaxK; ++k)
            if (k < K) acc[k] = __fadd_rn(acc[k], s_vals[i * K + k]);
        }
      }
    }
    if (mine < n_bins) {
      float* out = partial + (((int64_t)b * n_chunks + c) * n_bins + mine) * K;
      for (int k = 0; k < K; ++k) out[k] = acc[k];
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
  const size_t smem = kStage * sizeof(int32_t) + (size_t)kStage * K * sizeof(float);
  dim3 grid((unsigned)n_chunks, B);
  binned_sum_partial_kernel<<<grid, threads, smem, s>>>(vals, bins, partial, N, K,
                                                       n_bins, chunk, (int)n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)B * n_bins * K;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  binned_sum_combine_kernel<<<(unsigned)blocks, 256, 0, s>>>(partial, out, B,
                                                            (int)n_chunks, n_bins, K);
  return (int)cudaGetLastError();
}
