// Semi-global path aggregation, and the last path sweep fused with
// winner-take-all.
//
// Replaces the TPU kernels of stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py
// that sgm_wta_pallas chains: _sweep_vertical / _sweep_vertical_tiled
// (U, UL, UR and their reverses), _sweep_hT (the forward horizontal path) and
// _sweep_hT_wta (the reverse horizontal path with _wta_cell fused).
//
// srcv_sgm_path_sweep runs ONE direction r = (dx, dy) over the cropped cost
// volume C (H, W, D) int16 and writes, or adds onto, a u16 volume of that
// direction's (L - C) deltas. srcv_sgm_sweep_wta runs one more direction and
// reduces S = nd*C + deltas of every direction per pixel to the four WTA maps,
// so S never reaches device memory.
//
// What bounds it on an H100: each sweep streams C (2 B/cell) and reads and
// writes the u16 delta volume (4 B/cell), about 12 GB per direction at
// 3840x2160x256 cropped, against a dependent chain of a few dozen integer
// operations and two warp reductions per step along a path. The paths of one
// direction are independent, so the chain latency is hidden by running
// thousands of paths at once, and the next pixel's loads are issued before
// the current step is computed.
//
// Design (the GPU SGM of Hernandez-Juarez et al.): one warp per path line,
// the D disparities spread across the 32 lanes, K consecutive disparities per
// lane in registers, and a loop along the path. Paths start on the image
// border where the predecessor p - r falls outside, with a zero carry, so
// L = C at every path start (_scan_dir). The carry is normalised,
// lam = L - min_d L, and the step is _sgm_delta's form
//     delta(d) = min(lam[d], min(lam[d-1], lam[d+1]) + P1, P2)
// with no phantom neighbour at d = 0 or d = D - 1. Integer arithmetic
// throughout (the TPU kernel's f32 was a VPU workaround). Each pixel meets
// exactly one path per direction, so no atomics are needed: directions run as
// sequential launches on one stream.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 29;  // no-neighbour sentinel; BIG + P1 cannot overflow
constexpr int WARPS = 4;      // paths (warps) per block

// Start pixel of path i for direction (dx, dy); false past the last path.
__device__ __forceinline__ bool path_start(int i, int dx, int dy, int H, int W,
                                           int& y, int& x) {
  if (dy == 0) {
    if (i >= H) return false;
    y = i;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0) {
    if (i >= W) return false;
    x = i;
    y = dy > 0 ? 0 : H - 1;
  } else {
    if (i >= W + H - 1) return false;
    if (i < W) {
      x = i;
      y = dy > 0 ? 0 : H - 1;
    } else {
      const int j = i - W + 1;
      y = dy > 0 ? j : H - 1 - j;
      x = dx > 0 ? 0 : W - 1;
    }
  }
  return true;
}

template <int K>
__device__ __forceinline__ void load_cost(const int16_t* __restrict__ C, size_t base,
                                          int lane, int D, int (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    c[k] = d < D ? (int)C[base + d] : 0;
  }
}

// One DP step: delta from the carry, then the carry renormalised to
// lam' = t - min_d t with t = C + delta. Lanes' padding entries (d >= D)
// hold BIG and never win a min.
template <int K>
__device__ __forceinline__ void dp_step(int (&lam)[K], const int (&c)[K],
                                        int (&delta)[K], int lane, int D,
                                        int P1, int P2) {
  int below = __shfl_up_sync(FULL, lam[K - 1], 1);   // lam[d - 1] for k = 0
  int above = __shfl_down_sync(FULL, lam[0], 1);     // lam[d + 1] for k = K - 1
  if (lane == 0) below = BIG;
  if (lane == 31) above = BIG;
  int t[K];
  int m = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dm = k == 0 ? below : lam[k - 1];
    const int dp = k == K - 1 ? above : lam[k + 1];
    delta[k] = min(min(lam[k], P2), min(dm, dp) + P1);
    t[k] = lane * K + k < D ? c[k] + delta[k] : BIG;
    m = min(m, t[k]);
  }
  m = __reduce_min_sync(FULL, m);
#pragma unroll
  for (int k = 0; k < K; ++k) lam[k] = lane * K + k < D ? t[k] - m : BIG;
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
path_sweep_kernel(const int16_t* __restrict__ C, uint16_t* __restrict__ acc,
                  int H, int W, int D, int dx, int dy, int P1, int P2,
                  int accumulate) {
  const int lane = threadIdx.x & 31;
  int y, x;
  if (!path_start(blockIdx.x * WARPS + (threadIdx.x >> 5), dx, dy, H, W, y, x)) return;
  int lam[K], c[K], cn[K], delta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lam[k] = lane * K + k < D ? 0 : BIG;
    cn[k] = 0;
  }
  load_cost<K>(C, ((size_t)y * W + x) * D, lane, D, c);
  while (true) {
    const size_t base = ((size_t)y * W + x) * D;
    const int ny = y + dy, nx = x + dx;
    const bool more = ny >= 0 && ny < H && nx >= 0 && nx < W;
    if (more) load_cost<K>(C, ((size_t)ny * W + nx) * D, lane, D, cn);
    dp_step<K>(lam, c, delta, lane, D, P1, P2);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < D) {
        unsigned v = (unsigned)delta[k];
        if (accumulate) v += acc[base + d];
        acc[base + d] = (uint16_t)v;
      }
    }
    if (!more) break;
    y = ny;
    x = nx;
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = cn[k];
  }
}

// nd*C + the stored delta volumes for one pixel (dsb may be null).
template <int K>
__device__ __forceinline__ void load_partial(const int16_t* __restrict__ C,
                                             const uint16_t* __restrict__ dsa,
                                             const uint16_t* __restrict__ dsb,
                                             size_t base, int lane, int D, int nd,
                                             int (&c)[K], int (&s)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    if (d < D) {
      c[k] = (int)C[base + d];
      s[k] = nd * c[k] + (int)dsa[base + d] + (dsb ? (int)dsb[base + d] : 0);
    } else {
      c[k] = 0;
      s[k] = 0;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
sweep_wta_kernel(const int16_t* __restrict__ C, const uint16_t* __restrict__ dsa,
                 const uint16_t* __restrict__ dsb, float* __restrict__ disp,
                 uint8_t* __restrict__ valid, int32_t* __restrict__ best_out,
                 int32_t* __restrict__ mins_out, int H, int W, int D, int dx,
                 int dy, int nd, int P1, int P2, int ur, int min_disp, int lg) {
  const int lane = threadIdx.x & 31;
  int y, x;
  if (!path_start(blockIdx.x * WARPS + (threadIdx.x >> 5), dx, dy, H, W, y, x)) return;
  int lam[K], c[K], s[K], cn[K], sn[K], delta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lam[k] = lane * K + k < D ? 0 : BIG;
    cn[k] = 0;
    sn[k] = 0;
  }
  load_partial<K>(C, dsa, dsb, ((size_t)y * W + x) * D, lane, D, nd, c, s);
  const int dmask = (1 << lg) - 1;
  while (true) {
    const int ny = y + dy, nx = x + dx;
    const bool more = ny >= 0 && ny < H && nx >= 0 && nx < W;
    if (more) load_partial<K>(C, dsa, dsb, ((size_t)ny * W + nx) * D, lane, D, nd, cn, sn);
    dp_step<K>(lam, c, delta, lane, D, P1, P2);

    // Packed key S*Dp + d: one min gives minS and the smallest-d argmin.
    int key = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] += delta[k];
      const int d = lane * K + k;
      if (d < D) key = min(key, (s[k] << lg) + d);
    }
    key = __reduce_min_sync(FULL, key);
    const int best = key & dmask;
    const int minS = key >> lg;
    // Uniqueness: invalid if some |d - best| > 1 has S*(100 - ur) < minS*100.
    bool bad = false;
    unsigned sm1 = 0, sp1 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < D) {
        if (abs(d - best) > 1 && s[k] * (100 - ur) < minS * 100) bad = true;
        if (d == best - 1) sm1 = (unsigned)s[k];
        if (d == best + 1) sp1 = (unsigned)s[k];
      }
    }
    bad = __any_sync(FULL, bad);
    sm1 = __reduce_add_sync(FULL, sm1);  // one lane holds each neighbour
    sp1 = __reduce_add_sync(FULL, sp1);
    if (lane == 0) {
      // Parabolic subpixel, interior winners only, in f32 with the
      // reference's operation order and round-to-nearest intrinsics (no
      // contraction, no fast division).
      float dv = (float)best;
      if (best > 0 && best < D - 1) {
        const int Sm1 = (int)sm1, Sp1 = (int)sp1;
        const float denom = (float)max(Sm1 + Sp1 - 2 * minS, 1);
        dv = __fadd_rn(dv, __fdiv_rn((float)(Sm1 - Sp1), __fmul_rn(2.0f, denom)));
      } else {
        dv = __fadd_rn(dv, 0.0f);
      }
      const size_t o = (size_t)y * W + x;
      disp[o] = __fadd_rn(dv, (float)min_disp);
      valid[o] = bad ? 0 : 1;
      best_out[o] = best;
      mins_out[o] = minS;
    }
    if (!more) break;
    y = ny;
    x = nx;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = cn[k];
      s[k] = sn[k];
    }
  }
}

int num_paths(int dx, int dy, int H, int W) {
  if (dy == 0) return H;
  if (dx == 0) return W;
  return W + H - 1;
}

// Registers per lane: the smallest power of two K with 32*K >= D.
int lanes_k(int D) {
  int k = 1;
  while (32 * k < D) k *= 2;
  return k;
}

template <int K>
int launch_sweep(const void* C, void* acc, int H, int W, int D, int dx, int dy,
                 int P1, int P2, int accumulate, cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + WARPS - 1) / WARPS;
  path_sweep_kernel<K><<<blocks, 32 * WARPS, 0, stream>>>(
      (const int16_t*)C, (uint16_t*)acc, H, W, D, dx, dy, P1, P2, accumulate);
  return (int)cudaGetLastError();
}

template <int K>
int launch_wta(const void* C, const void* dsa, const void* dsb, void* disp,
               void* valid, void* best, void* mins, int H, int W, int D, int dx,
               int dy, int nd, int P1, int P2, int ur, int min_disp, int lg,
               cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + WARPS - 1) / WARPS;
  sweep_wta_kernel<K><<<blocks, 32 * WARPS, 0, stream>>>(
      (const int16_t*)C, (const uint16_t*)dsa, (const uint16_t*)dsb,
      (float*)disp, (uint8_t*)valid, (int32_t*)best, (int32_t*)mins, H, W, D,
      dx, dy, nd, P1, P2, ur, min_disp, lg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C: (H, W, D) int16; acc: (H, W, D) u16, written (accumulate = 0) or added
// onto (accumulate = 1). D <= 512.
int srcv_sgm_path_sweep(const void* C, void* acc, int H, int W, int D, int dx,
                        int dy, int P1, int P2, int accumulate, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_k(D)) {
    case 1: return launch_sweep<1>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, s);
    case 2: return launch_sweep<2>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, s);
    case 4: return launch_sweep<4>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, s);
    case 8: return launch_sweep<8>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, s);
    case 16: return launch_sweep<16>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Last direction fused with WTA. dsa, dsb: u16 delta volumes of the other
// directions (dsb may be null). Outputs (H, W): disp f32, valid u8,
// best i32, minS i32. lg = log2 of the power of two >= D.
int srcv_sgm_sweep_wta(const void* C, const void* dsa, const void* dsb,
                       void* disp, void* valid, void* best, void* mins, int H,
                       int W, int D, int dx, int dy, int nd, int P1, int P2,
                       int ur, int min_disp, int lg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SRCV_WTA(KK)                                                          \
  return launch_wta<KK>(C, dsa, dsb, disp, valid, best, mins, H, W, D, dx, dy, \
                        nd, P1, P2, ur, min_disp, lg, s)
  switch (lanes_k(D)) {
    case 1: SRCV_WTA(1);
    case 2: SRCV_WTA(2);
    case 4: SRCV_WTA(4);
    case 8: SRCV_WTA(8);
    case 16: SRCV_WTA(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRCV_WTA
}

}  // extern "C"
