// Segmentation-dynamics stencils for Hopper (sm_90a).
//
// successor_prop replaces aliby_tpu/ops/pallas_stencil.py successor_prop
// (_prop_kernel): n_prop rounds of key <- key[neighbour selected by dcode]
// (dcode in [0, 9), 4 = stay; any other value stays too).
//
// Why every round can run. Let S(p) be p's successor, with a successor off
// the grid an absorbing sink whose key is 0 (the zero pad of the plain and
// XLA loops). Then key_t(p) = key_0(S^t(p)). The reference stops a block of
// B rounds early when it left the key unchanged: key_{t+B} = key_t. A round
// is a function of the key alone, so then key_{t+B+s} = key_{t+s} for every
// s, and since n_prop - t is a multiple of B, key_{n_prop} = key_t. So the
// kernel computes key_0 o S^n_prop with no flag and no host decision, and
// gives the same bits as the early-exited loop.
//
// Design: successor-map doubling. S_1 is read from dcode; S_2m = S_m o S_m,
// with -1 (off the grid) staying -1; the powers in the binary digits of
// n_prop are composed into A as they are made, and the last launch composes
// the top power with A and gathers key_0: out(p) = S(p) < 0 ? 0 : key_0[S(p)].
// bit_length(n_prop) launches (7 at 96), no memset, no host synchronisation.
// The TPU kernel kept a whole image in VMEM for all rounds; here the maps
// (int32 flat indices within an image) stay in the 50 MB L2 at 16 x 256^2
// (4 MB each). Bound on the H100: device-memory bytes (dcode and key read
// once, key written once); each launch is a gather whose reach (2^k px)
// keeps it in L2, and a few integer operations per pixel.
//
// diffuse_heat replaces pallas_stencil.py diffuse_heat (_diffuse_kernel):
// n_iter rounds of T <- fg ? (U + sum_8 same-label-nbr U) / 9 : 0 with
// U = T + src. One launch makes each pixel's 16-bit flags (foreground, the
// 8 same-label neighbours). Then rounds are blocked in shared memory: a
// block owns a 64 x 64 output tile, loads an 82 x 82 region (a 9-px halo)
// of U = T + src, the sources and the flags, and runs up to 9 rounds
// there, double-buffered, one __syncthreads() a round; round r leaves
// exact every cell at least r from the region's edge, so the tile is exact
// after 9: 12 launches at 96 rounds. 94 KB of shared memory, two blocks an
// SM; each of the 640 threads owns a strip of 10 rows of one column and
// reads U through a sliding 3 x 3 window (3 shared loads a cell). Cells
// off the image hold U = 0 and no flags (the plain version's pads). The
// arithmetic is the reference's, in its order (acc = U, then + nb * m in
// _OFFSETS order, then a true division by 9, a background cell +0.0),
// with round-to-nearest intrinsics so that no FMA contraction changes a
// bit. Where the block's region holds only non-negative finite values
// (the main path: heat and centre sources), a masked neighbour adds +0.0
// and is skipped; elsewhere the multiply by the 0/1 flag stays, so a
// non-finite or negative value spreads exactly as the plain nb * m does.
// The division by 9 is correctly rounded by two FMAs that correct a
// multiply by 1/9 (div9): no branch, where __fdiv_rn leaves its fast path
// for the subnormal heat far from a centre. Bound on the H100: the f32
// instructions at the f32 issue rate (per foreground pixel and round, on
// the main path's data, an add for each same-label neighbour and the
// correctly rounded division).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------- successor_prop
constexpr int kBX = 32;  // block: 32 x 8 pixels
constexpr int kBY = 8;

// p's successor by its dcode: its flat index in the image, -1 off the grid;
// (qy, qx) its coordinates.
__device__ __forceinline__ int first_step(const int32_t* __restrict__ dcode, int y, int x,
                                          int H, int W, int& qy, int& qx) {
  int d = dcode[y * W + x];
  if (d < 0 || d > 8) d = 4;  // no selector matches: the key stays
  qy = y + d / 3 - 1;
  qx = x + d % 3 - 1;
  return (qy < 0 || qy >= H || qx < 0 || qx >= W) ? -1 : qy * W + qx;
}

// One doubling: P2 = P o P, where P is S_1 from dcode when P is null.
// compose 1: A = P (A was the identity); 2: A = P o A; 0: A untouched.
__global__ void __launch_bounds__(kBX * kBY)
succ_square_kernel(const int32_t* __restrict__ dcode, const int32_t* __restrict__ P,
                   int32_t* __restrict__ P2, int32_t* __restrict__ A, int compose, int H, int W) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int p = y * W + x;
  int q, r;
  if (P == nullptr) {
    int qy, qx, ry, rx;
    q = first_step(dcode + img, y, x, H, W, qy, qx);
    r = q < 0 ? -1 : first_step(dcode + img, qy, qx, H, W, ry, rx);
  } else {
    q = P[img + p];
    r = q < 0 ? -1 : P[img + q];
  }
  P2[img + p] = r;
  if (compose == 1) {
    A[img + p] = q;
  } else if (compose == 2) {  // P is a stored map here (the wrapper's plan)
    const int a = A[img + p];
    A[img + p] = a < 0 ? -1 : P[img + a];
  }
}

// The last launch: out = key0 o P o A (A null: the identity; P null: S_1
// from dcode, which the plan uses only with A the identity).
__global__ void __launch_bounds__(kBX * kBY)
succ_gather_kernel(const int32_t* __restrict__ dcode, const int32_t* __restrict__ P,
                   const int32_t* __restrict__ A, const int32_t* __restrict__ key0,
                   int32_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int p = y * W + x;
  int r;
  if (P == nullptr) {
    int qy, qx;
    r = first_step(dcode + img, y, x, H, W, qy, qx);
  } else {
    r = A == nullptr ? p : A[img + p];
    if (r >= 0) r = P[img + r];
  }
  out[img + p] = r < 0 ? 0 : key0[img + r];
}

// ------------------------------------------------------------- diffuse_heat
constexpr int kDTile = 64;                     // output tile edge
constexpr int kDHalo = 9;                      // most rounds a launch runs
constexpr int kDEdge = kDTile + 2 * kDHalo;    // loaded region edge (82)
constexpr int kDInner = kDEdge - 2;            // cells updated each round (80)
constexpr int kDStrip = 10;                    // rows of a thread's column strip
constexpr int kDThreads = kDInner * (kDInner / kDStrip);  // 640
constexpr int kDCells = kDEdge * kDEdge;
constexpr uint32_t kFg = 0x100;                // foreground, beside the 8 same-label bits
constexpr uint32_t kSmall = 0x71800000;        // bits of 2^100
static_assert(kDInner % kDStrip == 0, "strips must tile the updated cells");
// shared memory: two U buffers, the sources, the 16-bit flags (94,136
// bytes: two blocks an SM)
constexpr size_t kDSmem = 3 * kDCells * sizeof(float) + kDCells * sizeof(uint16_t);

// The correctly rounded a / 9 of a finite a >= +0.0: q0 = RN(a * RN(1/9))
// corrected once by the exact remainder a - 9 q0 (two FMAs). Checked
// against the correctly rounded quotient for every float below 2^-122 and
// every significand above, whose binades scale (tests/test_torch_stencil.py).
__device__ __forceinline__ float div9_nonneg(float a) {
  constexpr float kInv9 = 1.0f / 9.0f;
  const float q0 = __fmul_rn(a, kInv9);
  return __fmaf_rn(__fmaf_rn(-q0, 9.0f, a), kInv9, q0);
}

// The same for any float: RN is symmetric, so a negative a is exact too;
// a zero or an infinity is its own quotient (the sequence would give +0.0
// for -0.0, and NaN for an infinity).
__device__ __forceinline__ float div9(float a) {
  return (a == 0.0f || isinf(a)) ? a : div9_nonneg(a);
}

// The 16-bit flags of every pixel, once a call: foreground (kFg) and, in
// _OFFSETS order, whether each of the 8 neighbours has the same label (a
// neighbour off the image has label -1, the plain version's pad).
__global__ void __launch_bounds__(kBX * kBY)
diffuse_flags_kernel(const int32_t* __restrict__ labels, uint16_t* __restrict__ flags, int H,
                     int W) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int32_t* lab = labels + (int64_t)blockIdx.z * H * W;
  const int32_t l = lab[y * W + x];
  uint32_t bits = l > 0 ? kFg : 0;
  int k = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int yy = y + dy, xx = x + dx;
      const int32_t n = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? lab[yy * W + xx] : -1;
      if (n == l) bits |= 1u << k;
      ++k;
    }
  }
  flags[(int64_t)blockIdx.z * H * W + y * W + x] = (uint16_t)bits;
}

// One round over a thread's strip: rows lo .. hi - 1 of column cx.
// kNonNeg: every U and source of the region is +0.0 or positive, finite
// and below 2^100, so each U stays so for kDHalo rounds; then nb * 0 is
// +0.0 and acc + (+0.0) = acc for acc >= +0.0, so a masked neighbour is
// skipped with the same bits. Otherwise every term is taken as the plain
// version takes it. out_row0: null but in the last
// round, where the tile's rows are written to T_out instead of the next U.
template <bool kNonNeg>
__device__ __forceinline__ void diffuse_round(const float* __restrict__ u, float* __restrict__ nxt,
                                              const float* __restrict__ s_src,
                                              const uint16_t* __restrict__ s_m, int cx, int lo,
                                              int hi, float* __restrict__ out_row0, int W) {
  int c = lo * kDEdge + cx;
  const float* row = u + c - kDEdge;
  float a0 = row[-1], a1 = row[0], a2 = row[1];
  row += kDEdge;
  float b0 = row[-1], b1 = row[0], b2 = row[1];
#pragma unroll 2
  for (int r = lo; r < hi; ++r, c += kDEdge) {
    row += kDEdge;
    const float d0 = row[-1], d1 = row[0], d2 = row[1];
    const uint32_t m = s_m[c];
    float t = 0.0f;
    if (m & kFg) {
      const float nb[8] = {a0, a1, a2, b0, b2, d0, d1, d2};
      float acc = b1;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (kNonNeg) {
          if (m & (1u << k)) acc = __fadd_rn(acc, nb[k]);
        } else {
          acc = __fadd_rn(acc, __fmul_rn(nb[k], (m & (1u << k)) ? 1.0f : 0.0f));
        }
      }
      t = kNonNeg ? div9_nonneg(acc) : div9(acc);
    }
    if (out_row0 == nullptr) {
      nxt[c] = __fadd_rn(t, s_src[c]);
    } else {
      out_row0[(int64_t)(r - kDHalo) * W] = t;
    }
    a0 = b0, a1 = b1, a2 = b2;
    b0 = d0, b1 = d1, b2 = d2;
  }
}

// One launch: `rounds` (1..kDHalo) rounds from T_in (null: T = 0) to T_out.
__global__ void __launch_bounds__(kDThreads, 2)
diffuse_rounds_kernel(const uint16_t* __restrict__ flags, const float* __restrict__ src,
                      const float* __restrict__ T_in, float* __restrict__ T_out, int H, int W,
                      int rounds) {
  extern __shared__ float s_u[];  // [2][kDCells] U, [kDCells] sources, [kDCells] flags
  float* s_src = s_u + 2 * kDCells;
  uint16_t* s_m = reinterpret_cast<uint16_t*>(s_src + kDCells);
  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * kDTile - kDHalo;
  const int x0 = blockIdx.x * kDTile - kDHalo;
  const int tid = threadIdx.x;

  // U, the sources and the flags of the region; a cell off the image U = 0,
  // flags 0. Every load of a thread is issued before any is used.
  constexpr int kLoads = (kDCells + kDThreads - 1) / kDThreads;
  float tv[kLoads], sv[kLoads];
  uint16_t mv[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int i = tid + n * kDThreads;
    const int gy = y0 + i / kDEdge;
    const int gx = x0 + i % kDEdge;
    tv[n] = sv[n] = 0.0f;
    mv[n] = 0;
    if (i < kDCells && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int64_t g = img + (int64_t)gy * W + gx;
      sv[n] = src[g];
      if (T_in != nullptr) tv[n] = T_in[g];
      mv[n] = flags[g];
    }
  }
  bool small = true;  // every U and source +0.0 or positive, finite, below 2^100
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int i = tid + n * kDThreads;
    if (i < kDCells) {
      const float u = __fadd_rn(tv[n], sv[n]);
      small &= __float_as_uint(sv[n]) < kSmall && __float_as_uint(u) < kSmall;
      s_u[i] = u;
      s_src[i] = sv[n];
      s_m[i] = mv[n];
    }
  }
  const bool non_neg = __syncthreads_and(small);

  // this thread's cells: column cx, rows ry0 .. ry0 + kDStrip - 1 (region
  // coordinates, all at least 1 from the edge)
  const int cx = 1 + tid % kDInner;
  const int ry0 = 1 + (tid / kDInner) * kDStrip;
  const int gx = x0 + cx;
  const bool tile_col = cx >= kDHalo && cx < kDHalo + kDTile && gx < W;
  const int tile_hi = min(kDHalo + kDTile, H - y0);  // the tile's rows inside the image
  for (int r = 0; r < rounds; ++r) {
    const float* u = s_u + (r & 1) * kDCells;
    float* nxt = s_u + ((r & 1) ^ 1) * kDCells;
    // every updated row; in the last round the tile's rows only
    const bool last = r == rounds - 1;
    const int lo = last ? max(ry0, kDHalo) : ry0;
    const int hi = last ? min(ry0 + kDStrip, tile_hi) : ry0 + kDStrip;
    if (!last || tile_col) {
      float* out_row0 = last ? T_out + img + (int64_t)(y0 + kDHalo) * W + gx : nullptr;
      if (non_neg)
        diffuse_round<true>(u, nxt, s_src, s_m, cx, lo, hi, out_row0, W);
      else
        diffuse_round<false>(u, nxt, s_src, s_m, cx, lo, hi, out_row0, W);
    }
    __syncthreads();
  }
}

}  // namespace

// out receives B * H * W int32 keys; maps holds 3 * B * H * W int32 of
// scratch (two powers and A; null for n_prop = 1). H * W < 2^31.
// bit_length(n_prop) launches; n_prop = 0 is the caller's (a copy of key0).
extern "C" int successor_prop(const int32_t* dcode, const int32_t* key0, int32_t* out,
                              int32_t* maps, int B, int H, int W, int n_prop, void* stream) {
  if (n_prop < 1 || B < 1 || B > 65535 || H < 1 || W < 1 || (int64_t)H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B);
  const int64_t n = (int64_t)B * H * W;
  int L = 0;
  while ((n_prop >> L) > 0) ++L;
  if (L > 1 && maps == nullptr) return (int)cudaErrorInvalidValue;
  int32_t* pbuf[2] = {maps, L > 1 ? maps + n : nullptr};
  int32_t* A = L > 1 ? maps + 2 * n : nullptr;
  bool a_set = false;
  const int32_t* P = nullptr;  // S_{2^k}; null: S_1 from dcode
  for (int k = 0; k < L - 1; ++k) {
    int compose = 0;
    if ((n_prop >> k) & 1) compose = a_set ? 2 : 1;
    int32_t* P2 = pbuf[k & 1];
    succ_square_kernel<<<grid, block, 0, s>>>(dcode, P, P2, A, compose, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a_set |= compose != 0;
    P = P2;
  }
  succ_gather_kernel<<<grid, block, 0, s>>>(dcode, P, a_set ? A : nullptr, key0, out, H, W);
  return (int)cudaGetLastError();
}

// out and tmp receive B * H * W floats each (tmp: scratch of the ping-pong),
// flags B * H * W uint16 of scratch. 1 + ceil(n_iter / 9) launches (12 at
// 96): the flags, then rounds of kDSmem bytes of shared memory each.
extern "C" int diffuse_heat(const int32_t* labels, const float* src, float* out, float* tmp,
                            uint16_t* flags, int B, int H, int W, int n_iter, void* stream) {
  if (n_iter < 1 || B < 1 || B > 65535 || H < 1 || W < 1 || (int64_t)H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // per device, so set on every call (a host-side attribute, no launch)
  cudaError_t e = cudaFuncSetAttribute(diffuse_rounds_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  diffuse_flags_kernel<<<dim3((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B), dim3(kBX, kBY), 0,
                         s>>>(labels, flags, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kDTile - 1) / kDTile, (H + kDTile - 1) / kDTile, B);
  const int n_launch = (n_iter + kDHalo - 1) / kDHalo;
  const float* T = nullptr;
  int left = n_iter;
  for (int i = 0; i < n_launch; ++i) {
    // the last launch writes out: launch i writes out when n_launch - 1 - i is even
    float* dst = ((n_launch - 1 - i) & 1) ? tmp : out;
    const int rounds = i == 0 ? left - (n_launch - 1) * kDHalo : kDHalo;
    diffuse_rounds_kernel<<<grid, kDThreads, kDSmem, s>>>(flags, src, T, dst, H, W, rounds);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    left -= rounds;
    T = dst;
  }
  return 0;
}
