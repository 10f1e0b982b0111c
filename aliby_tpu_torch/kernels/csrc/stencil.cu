// Segmentation-dynamics stencils for Hopper (sm_90a).
//
// successor_prop_rounds replaces aliby_tpu/ops/pallas_stencil.py
// successor_prop (_prop_kernel): `rounds` rounds of
// key <- key[neighbour selected by dcode] (dcode in [0, 9), 4 = stay).
// The TPU kernel keeps a whole image in VMEM for all rounds; a 256x256
// int32 key is 256 KB, more than the 227 KB of shared memory a block can
// hold. Here each block owns a 32x32 output tile and loads it with a 6-px
// halo (44x44) into shared memory, then runs up to 6 rounds there
// (temporal blocking): succ^r(p) lies within r px of p, so after r rounds
// the cells at least r px inside the loaded region are exact, and the
// tile interior is exact after 6. Halo cells outside the image hold key 0
// and stay, which is the zero padding of the plain version (the caller
// clips border successors in-grid, so on the segmentation path they are
// never selected). Bound on the H100: device-memory bytes (one read of
// dcode and key, one write of key per launch); the integer selects are a
// few operations per pixel and round.
//
// diffuse_step replaces pallas_stencil.py diffuse_heat (_diffuse_kernel):
// one round of T <- fg ? (T+src + sum_8 same-label-nbr (T+src)) / 9 : 0,
// one launch per round, ping-pong buffers. The 8 same-label neighbour flags
// and the foreground flag are precomputed once (diffuse_mask) as one 16-bit
// word per pixel. The arithmetic keeps the reference's order (acc = T+src,
// then + nb*m in _OFFSETS order, then a true division by 9) with explicit
// round-to-nearest intrinsics, so no FMA contraction can change the bits:
// the result is bit-equal to the plain PyTorch version. Bound on the H100:
// the float operations (18 per pixel and round) when the field is L2-resident.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                  // output tile edge
constexpr int kHalo = 6;                   // most rounds per launch
constexpr int kEdge = kTile + 2 * kHalo;   // loaded region edge (44)
constexpr int kPropThreads = 256;
constexpr int kThreads = 256;

__global__ void successor_prop_kernel(const int32_t* __restrict__ dcode,
                                      const int32_t* __restrict__ key_in,
                                      int32_t* __restrict__ key_out,
                                      int* __restrict__ changed,
                                      int H, int W, int rounds) {
  __shared__ int32_t buf[2][kEdge * kEdge];
  __shared__ int16_t off[kEdge * kEdge];  // successor offset in region cells

  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;

  for (int i = threadIdx.x; i < kEdge * kEdge; i += kPropThreads) {
    const int gy = y0 + i / kEdge;
    const int gx = x0 + i % kEdge;
    int d = 4;
    int32_t k = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int64_t g = img + (int64_t)gy * W + gx;
      d = dcode[g];
      k = key_in[g];
      if (d < 0 || d > 8) d = 4;  // no selector matches: the key stays
    }
    off[i] = (int16_t)((d / 3 - 1) * kEdge + (d % 3 - 1));
    buf[0][i] = k;
  }

  // Round r updates the cells at least r from the region's edge; they read
  // cells at least r-1 from it, which round r-1 left exact.
  int cur = 0;
  for (int r = 1; r <= rounds; ++r) {
    __syncthreads();
    const int span = kEdge - 2 * r;
    for (int i = threadIdx.x; i < span * span; i += kPropThreads) {
      const int c = (r + i / span) * kEdge + (r + i % span);
      buf[cur ^ 1][c] = buf[cur][c + off[c]];
    }
    cur ^= 1;
  }
  __syncthreads();

  int any = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += kPropThreads) {
    const int ty = i / kTile;
    const int tx = i % kTile;
    const int gy = y0 + kHalo + ty;
    const int gx = x0 + kHalo + tx;
    if (gy < H && gx < W) {
      const int64_t g = img + (int64_t)gy * W + gx;
      const int32_t v = buf[cur][(kHalo + ty) * kEdge + kHalo + tx];
      any |= (v != key_in[g]);
      key_out[g] = v;
    }
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *changed = 1;
}

__global__ void diffuse_mask_kernel(const int32_t* __restrict__ labels,
                                    uint16_t* __restrict__ mask, int H, int W,
                                    int64_t total) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t hw = (int64_t)H * W;
    const int64_t p = idx % hw;
    const int y = (int)(p / W);
    const int x = (int)(p % W);
    const int32_t l = labels[idx];
    uint16_t m = l > 0 ? 0x100 : 0;
    int k = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int yy = y + dy;
        const int xx = x + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W && labels[idx + dy * W + dx] == l)
          m |= (uint16_t)(1u << k);
        ++k;
      }
    }
    mask[idx] = m;
  }
}

__global__ void diffuse_step_kernel(const float* __restrict__ T,
                                    const float* __restrict__ src,
                                    const uint16_t* __restrict__ mask,
                                    float* __restrict__ out, int H, int W,
                                    int64_t total) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const uint16_t m = mask[idx];
    if (!(m & 0x100)) {
      out[idx] = 0.0f;
      continue;
    }
    const int64_t hw = (int64_t)H * W;
    const int64_t p = idx % hw;
    const int y = (int)(p / W);
    const int x = (int)(p % W);
    float acc = __fadd_rn(T[idx], src[idx]);
    int k = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int yy = y + dy;
        const int xx = x + dx;
        float nb = 0.0f;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const int64_t q = idx + dy * W + dx;
          nb = __fadd_rn(T[q], src[q]);
        }
        const float mk = ((m >> k) & 1) ? 1.0f : 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(nb, mk));
        ++k;
      }
    }
    out[idx] = __fdiv_rn(acc, 9.0f);
  }
}

int grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 * 8 ? blocks : 65535 * 8);
}

}  // namespace

extern "C" int successor_prop_rounds(const int32_t* dcode, const int32_t* key_in,
                                     int32_t* key_out, int* changed, int B, int H,
                                     int W, int rounds, void* stream) {
  if (rounds < 1 || rounds > kHalo || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  successor_prop_kernel<<<grid, kPropThreads, 0, s>>>(dcode, key_in, key_out,
                                                      changed, H, W, rounds);
  return (int)cudaGetLastError();
}

extern "C" int diffuse_mask(const int32_t* labels, uint16_t* mask, int B, int H,
                            int W, void* stream) {
  const int64_t total = (int64_t)B * H * W;
  if (total < 1) return (int)cudaErrorInvalidValue;
  diffuse_mask_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      labels, mask, H, W, total);
  return (int)cudaGetLastError();
}

extern "C" int diffuse_step(const float* T, const float* src, const uint16_t* mask,
                            float* out, int B, int H, int W, void* stream) {
  const int64_t total = (int64_t)B * H * W;
  if (total < 1) return (int)cudaErrorInvalidValue;
  diffuse_step_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      T, src, mask, out, H, W, total);
  return (int)cudaGetLastError();
}
