// Hole filling of label images for Hopper (sm_90a).
//
// fill_label_holes replaces no TPU kernel: the JAX package fills holes with
// a lax.while_loop of jnp stencil rounds (aliby_tpu/models/flows.py
// fill_label_holes), which the port's plain version repeats. On the card
// that loop took some 230 rounds of 26 launches over a call's (18, 1080,
// 1080) labels, checked from the host every 8 rounds, and most of the
// flow-error QC's time: the background that is not straight-line visible
// from the border was a quarter of a cell map, so its components are large.
// This kernel labels those components once and gives the same integers.
//
// What it computes (the plain version's, for a contiguous (B, H, W) int32
// batch): vis = background visible from the border along its row or its
// column; rest = background & ~vis. Each 4-connected rest component takes
// the min over its pixels of the least positive 4-neighbour label (BIG if
// none), and the max over its pixels of max(0, each in-grid neighbour's
// label, BIG for a vis neighbour). Where min == max, min > 0 and max < BIG,
// the component takes that label; every other pixel keeps its own. Integer
// min and max do not depend on order, so the output is bit-equal to the
// plain version's whatever order the atomics land in.
//
// Design: union-find in device memory (Playne & Hawick, IEEE TPDS 2018),
// five launches, no host synchronisation, no memset.
//   1. bounds: the first and last non-zero index of every row and column
//      (a pixel is vis when it lies outside them in its row or column: the
//      four cumsums of the plain version without them).
//   2. init: out = labels; each rest pixel its own root, its min and max
//      seeds at its own index; parent -1 off rest.
//   3. link: each rest pixel joins its left and upper rest neighbours
//      (atomicMin links a root to the smaller root). The upper join is
//      skipped where the left and upper-left pixels are rest too: the row
//      to the left has joined those two rows already.
//   4. fold: each rest pixel points at its root and folds its seeds into
//      the root's with atomics (none where a seed would change nothing).
//   5. write: a rest pixel whose root's min and max make it fillable takes
//      the label (the root found again: a halving store in the fold may
//      land after a pixel's own, a hop short of the root).
// Finds halve the path they walk (each pixel on it is pointed at its
// grandparent, an ancestor in the same set), so long runs of rest do not
// make long walks. Never a link across images: every index is within one
// image.
//
// Bound on the H100: device-memory bytes. The least is the labels read
// once and written once; these launches read the labels twice (bounds and
// init, with the neighbours from L1 and L2) and write and read back the
// parents and the seeds of the rest pixels, a few integer operations a
// pixel, and atomics only where a seed moves a root's min or max.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;            // the bounds' blocks are kT x kT
constexpr int kBig = 1 << 30;     // the plain version's BIG_I32
constexpr int kLinear = 256;      // threads of the other blocks

// The root of i (parents point at smaller indices; a root at itself),
// halving the path on the way. Volatile: other threads link and halve
// while this one walks; every store is an ancestor of the same set. A
// halving store may overwrite the atomicMin of a join that found this
// pixel a root too late; that join saw the old parent and retries from it
// (join below), so no union is lost.
__device__ __forceinline__ int find_root(volatile int* par, int i) {
  int p;
  while ((p = par[i]) != i) {
    const int g = par[p];
    if (g != p) par[i] = g;
    i = p;
  }
  return i;
}

// Join the sets of a and b: link the larger root to the smaller with
// atomicMin, again from the new roots until a link lands on a root.
__device__ void join(int* par, int a, int b) {
  bool done;
  do {
    a = find_root(par, a);
    b = find_root(par, b);
    if (a < b) {
      const int old = atomicMin(&par[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&par[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// 1. The first and last non-zero row of each column (blocks below
// n_col_blocks: kT columns a block, kT row phases) and column of each row
// (the rest: a warp a row). An empty line reads (H or W, -1).
__global__ void __launch_bounds__(kT * kT)
hole_bounds_kernel(const int32_t* __restrict__ labels, int32_t* __restrict__ rlo,
                   int32_t* __restrict__ rhi, int32_t* __restrict__ clo,
                   int32_t* __restrict__ chi, int H, int W, int n_col_blocks) {
  const int img = blockIdx.y;
  const int32_t* lab = labels + (int64_t)img * H * W;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if ((int)blockIdx.x < n_col_blocks) {
    __shared__ int s_lo[kT][kT + 1], s_hi[kT][kT + 1];
    const int x = blockIdx.x * kT + tx;
    int lo = H, hi = -1;
    if (x < W) {
#pragma unroll 4
      for (int y = ty; y < H; y += kT) {
        if (lab[(int64_t)y * W + x] != 0) {
          lo = min(lo, y);
          hi = y;
        }
      }
    }
    s_lo[ty][tx] = lo;
    s_hi[ty][tx] = hi;
    __syncthreads();
    if (ty == 0 && x < W) {
      for (int k = 1; k < kT; ++k) {
        lo = min(lo, s_lo[k][tx]);
        hi = max(hi, s_hi[k][tx]);
      }
      clo[(int64_t)img * W + x] = lo;
      chi[(int64_t)img * W + x] = hi;
    }
  } else {
    const int y = (blockIdx.x - n_col_blocks) * kT + ty;
    if (y >= H) return;  // the whole warp
    int lo = W, hi = -1;
#pragma unroll 4
    for (int x = tx; x < W; x += kT) {
      if (lab[(int64_t)y * W + x] != 0) {
        lo = min(lo, x);
        hi = x;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (tx == 0) {
      rlo[(int64_t)img * H + y] = lo;
      rhi[(int64_t)img * H + y] = hi;
    }
  }
}

// 2. out = labels; a rest pixel's parent is itself and its seeds sit at
// its index; every other pixel's parent is -1.
__global__ void __launch_bounds__(kLinear)
hole_init_kernel(const int32_t* __restrict__ labels, const int32_t* __restrict__ rlo,
                 const int32_t* __restrict__ rhi, const int32_t* __restrict__ clo,
                 const int32_t* __restrict__ chi, int32_t* __restrict__ out,
                 int32_t* __restrict__ par, int32_t* __restrict__ cmin,
                 int32_t* __restrict__ cmax, int H, int W) {
  const int64_t t = (int64_t)blockIdx.x * kLinear + threadIdx.x;
  if (t >= (int64_t)H * W) return;
  const int p = (int)t, y = p / W, x = p - y * W;
  const int img = blockIdx.y;
  const int64_t o = (int64_t)img * H * W;
  const int32_t* lab = labels + o;
  rlo += (int64_t)img * H;
  rhi += (int64_t)img * H;
  clo += (int64_t)img * W;
  chi += (int64_t)img * W;
  // a pixel of value v at (yy, xx): vis?
  auto vis = [&](int yy, int xx, int v) {
    return v == 0 && (yy < clo[xx] || yy > chi[xx] || xx < rlo[yy] || xx > rhi[yy]);
  };
  const int l = lab[p];
  out[o + p] = l;
  const bool rest = l == 0 && !vis(y, x, 0);
  par[o + p] = rest ? p : -1;
  if (!rest) return;
  int smin = kBig, smax = 0;
  const int dys[4] = {-1, 1, 0, 0}, dxs[4] = {0, 0, -1, 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y + dys[k], xx = x + dxs[k];
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // the plain pad: 0, not vis
    const int v = lab[yy * W + xx];
    if (v > 0) smin = min(smin, v);
    smax = max(smax, vis(yy, xx, v) ? kBig : v);
  }
  // no BIG for the image border: a background pixel there is vis, never rest
  cmin[o + p] = smin;
  cmax[o + p] = smax;
}

// 3. Each rest pixel joins its left and upper rest neighbours.
__global__ void __launch_bounds__(kLinear)
hole_link_kernel(int32_t* __restrict__ par, int H, int W) {
  const int64_t t = (int64_t)blockIdx.x * kLinear + threadIdx.x;
  if (t >= (int64_t)H * W) return;
  const int p = (int)t, y = p / W, x = p - y * W;
  int* pr = par + (int64_t)blockIdx.y * H * W;
  if (pr[p] < 0) return;  // a parent is -1 off rest and stays so
  const bool left = x > 0 && pr[p - 1] >= 0;
  if (left) join(pr, p, p - 1);
  if (y > 0 && pr[p - W] >= 0 && !(left && pr[p - W - 1] >= 0)) join(pr, p, p - W);
}

// 4. Each rest pixel points at its root and folds its seeds into it.
__global__ void __launch_bounds__(kLinear)
hole_fold_kernel(int32_t* __restrict__ par, int32_t* __restrict__ cmin,
                 int32_t* __restrict__ cmax, int H, int W) {
  const int64_t t = (int64_t)blockIdx.x * kLinear + threadIdx.x;
  if (t >= (int64_t)H * W) return;
  const int p = (int)t;
  const int64_t o = (int64_t)blockIdx.y * H * W;
  int* pr = par + o;
  if (pr[p] < 0) return;
  const int r = find_root(pr, p);
  if (r == p) return;
  pr[p] = r;
  // a root's min only falls and its max only rises: skip what moves neither
  const int mn = cmin[o + p], mx = cmax[o + p];
  if (mn < ((volatile int32_t*)cmin)[o + r]) atomicMin(&cmin[o + r], mn);
  if (mx > ((volatile int32_t*)cmax)[o + r]) atomicMax(&cmax[o + r], mx);
}

// 5. A rest pixel whose component is fillable takes its label.
__global__ void __launch_bounds__(kLinear)
hole_write_kernel(const int32_t* __restrict__ par, const int32_t* __restrict__ cmin,
                  const int32_t* __restrict__ cmax, int32_t* __restrict__ out, int H, int W) {
  const int64_t t = (int64_t)blockIdx.x * kLinear + threadIdx.x;
  if (t >= (int64_t)H * W) return;
  const int p = (int)t;
  const int64_t o = (int64_t)blockIdx.y * H * W;
  const int32_t* pr = par + o;
  int r = pr[p];
  if (r < 0) return;
  // a hop or two: a halving store in the fold may land after the pixel's own
  for (int q; (q = pr[r]) != r;) r = q;
  const int mn = cmin[o + r], mx = cmax[o + r];
  if (mn == mx && mn > 0 && mx < kBig) out[o + p] = mn;
}

}  // namespace

// labels and out: B * H * W int32; bounds: 2 * B * (H + W) int32 of
// scratch; maps: 3 * B * H * W int32 of scratch (parents, min, max).
// H * W < 2^31, B <= 65535. Five launches on `stream`.
extern "C" int fill_label_holes(const int32_t* labels, int32_t* out, int32_t* bounds,
                                int32_t* maps, int B, int H, int W, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (int64_t)H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)B * H * W;
  int32_t* rlo = bounds;
  int32_t* rhi = rlo + (int64_t)B * H;
  int32_t* clo = rhi + (int64_t)B * H;
  int32_t* chi = clo + (int64_t)B * W;
  int32_t* par = maps;
  int32_t* cmin = maps + n;
  int32_t* cmax = maps + 2 * n;
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;

  hole_bounds_kernel<<<dim3(tiles_x + tiles_y, B), dim3(kT, kT), 0, s>>>(labels, rlo, rhi, clo,
                                                                        chi, H, W, tiles_x);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 linear((unsigned)(((int64_t)H * W + kLinear - 1) / kLinear), B);
  hole_init_kernel<<<linear, kLinear, 0, s>>>(labels, rlo, rhi, clo, chi, out, par, cmin, cmax,
                                              H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hole_link_kernel<<<linear, kLinear, 0, s>>>(par, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hole_fold_kernel<<<linear, kLinear, 0, s>>>(par, cmin, cmax, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hole_write_kernel<<<linear, kLinear, 0, s>>>(par, cmin, cmax, out, H, W);
  return (int)cudaGetLastError();
}
