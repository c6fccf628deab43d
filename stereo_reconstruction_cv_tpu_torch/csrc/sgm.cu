// Semi-global path aggregation, and the last path sweep fused with
// winner-take-all.
//
// Replaces the TPU kernels of stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py
// that sgm_wta_pallas chains: _sweep_vertical / _sweep_vertical_tiled
// (U, UL, UR and their reverses), _sweep_hT (the forward horizontal path) and
// _sweep_hT_wta (the reverse horizontal path with _wta_cell fused); and those
// of sgm_aggregate_pallas (the full S volume), whose horizontal paths
// _sweep_horizontal runs: ops/cuda/sgm.py:sgm_aggregate_cuda sweeps every
// direction with srcv_sgm_path_sweep.
//
// srcv_sgm_path_sweep runs ONE direction r = (dx, dy) over the cropped cost
// volume C (H, W, D) int16 and writes, or adds onto, a u16 volume of that
// direction's (L - C) deltas. srcv_sgm_sweep_wta runs one more direction and
// reduces S = nd*C + deltas of every direction per pixel to the four WTA maps,
// so S never reaches device memory.
//
// Numerics (the GPU SGM of Hernandez-Juarez et al.): one warp per path line,
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
//
// What bounds path_sweep_kernel on an H100 (measured, chip_smoke.py's time of
// each direction alone): a launch streams C (2 B/cell) and reads and writes
// the u16 delta volume (4 B/cell). The first design loaded a step's C one
// step ahead and its delta volume in the step itself, 2 bytes per load. At
// 720p x 128 its time followed the path length (1.3 ms for 1152 steps, 0.87
// ms for 720, 1.1-1.2 us a step whatever the direction): one DRAM round trip
// per step. At 4K x 256 all directions took 11.5-12.3 ms whatever the path
// length, about 1 TB/s: too few bytes in flight per warp.
//
// The design now: each lane moves its K disparities as one access (2K bytes:
// 8 at D = 128, 16 at D = 256) where D % K == 0 and the volumes are aligned,
// else K scalar accesses (the general path, same kernel body). C and the
// delta volume are loaded P steps ahead into a ring of registers, so a step
// waits on no memory: a later pixel's delta can be read early because no
// other step of this direction writes it. Blocks hold two warps, to spread
// the few paths of a 720p direction over all SMs. dp_step and the fused
// sweep_wta_kernel are unchanged.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 29;  // no-neighbour sentinel; BIG + P1 cannot overflow
constexpr int WARPS = 4;      // paths (warps) per block of sweep_wta_kernel

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

// Steps of a path from (y, x) along (dx, dy) until it leaves the image.
__device__ __forceinline__ int path_steps(int y, int x, int dx, int dy, int H, int W) {
  int n = INT_MAX;
  if (dx > 0) n = W - x;
  if (dx < 0) n = x + 1;
  if (dy > 0) n = min(n, H - y);
  if (dy < 0) n = min(n, y + 1);
  return n;
}

// One lane's K 16-bit values, two to a 32-bit word (the even d in the low half).
template <int K>
struct Row {
  uint32_t w[(K + 1) / 2];
};

// The lane's K values at p: one access of 2K bytes (VEC; p aligned to
// min(2K, 16) bytes and all K valid), else K scalar loads of which the first
// `valid` are read and the rest are 0.
template <int K, bool VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, int valid, Row<K>& r) {
  if constexpr (VEC) {
    if constexpr (K == 1) {
      r.w[0] = p[0];
    } else if constexpr (K == 2) {
      r.w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (K == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.w[0] = v.x;
      r.w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < K / 8; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        r.w[4 * i] = v.x;
        r.w[4 * i + 1] = v.y;
        r.w[4 * i + 2] = v.z;
        r.w[4 * i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const uint32_t lo = k < valid ? p[k] : 0u;
      const uint32_t hi = k + 1 < K && k + 1 < valid ? p[k + 1] : 0u;
      r.w[k / 2] = lo | (hi << 16);
    }
  }
}

template <int K, bool VEC>
__device__ __forceinline__ void store_row(uint16_t* p, int valid, const Row<K>& r) {
  if constexpr (VEC) {
    if constexpr (K == 1) {
      p[0] = (uint16_t)r.w[0];
    } else if constexpr (K == 2) {
      *reinterpret_cast<uint32_t*>(p) = r.w[0];
    } else if constexpr (K == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < K / 8; ++i) {
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < valid) p[k] = (uint16_t)(r.w[k / 2] >> (16 * (k & 1)));
    }
  }
}

// Value k of a row: sign-extended (int16 C) or zero-extended (u16 deltas).
template <int K>
__device__ __forceinline__ int row_s16(const Row<K>& r, int k) {
  return k & 1 ? (int)r.w[k / 2] >> 16 : (int)(int16_t)(r.w[k / 2] & 0xffffu);
}
template <int K>
__device__ __forceinline__ uint32_t row_u16(const Row<K>& r, int k) {
  return k & 1 ? r.w[k / 2] >> 16 : r.w[k / 2] & 0xffffu;
}

constexpr int SWEEP_WARPS = 2;  // paths (warps) per block of path_sweep_kernel

// Steps loaded ahead: a ring of P rows of C and of the delta volume per lane
// (2 * P * ceil(K/2) registers).
template <int K>
constexpr int RING_STEPS = K <= 2 ? 16 : (K <= 8 ? 8 : 4);

template <int K, bool VEC>
__global__ void __launch_bounds__(32 * SWEEP_WARPS)
path_sweep_kernel(const int16_t* __restrict__ C, uint16_t* __restrict__ acc,
                  int H, int W, int D, int dx, int dy, int P1, int P2,
                  int accumulate) {
  constexpr int P = RING_STEPS<K>;
  const int lane = threadIdx.x & 31;
  int y, x;
  if (!path_start(blockIdx.x * SWEEP_WARPS + (threadIdx.x >> 5), dx, dy, H, W, y, x)) return;
  const int n = path_steps(y, x, dx, dy, H, W);
  const long long step = ((long long)dy * W + dx) * D;  // elements per path step
  const size_t first = ((size_t)y * W + x) * D + (size_t)lane * K;
  const uint16_t* cp = reinterpret_cast<const uint16_t*>(C) + first;
  uint16_t* ap = acc + first;
  const int valid = D - lane * K;  // with VEC, either <= 0 or >= K
  const bool active = valid > 0;

  Row<K> cr[P], ar[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int i = 0; i < (K + 1) / 2; ++i) {
      cr[j].w[i] = 0;
      ar[j].w[i] = 0;
    }
    if (active && j < n) {
      load_row<K, VEC>(cp + j * step, valid, cr[j]);
      if (accumulate) load_row<K, VEC>(ap + j * step, valid, ar[j]);
    }
  }
  int lam[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lam[k] = lane * K + k < D ? 0 : BIG;

  for (int s0 = 0; s0 < n; s0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = s0 + j;
      if (s >= n) break;
      int c[K], delta[K];
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] = row_s16<K>(cr[j], k);
      dp_step<K>(lam, c, delta, lane, D, P1, P2);
      if (active) {
        Row<K> out;
#pragma unroll
        for (int k = 0; k < K; k += 2) {
          const uint32_t lo = (uint32_t)delta[k] + (accumulate ? row_u16<K>(ar[j], k) : 0u);
          const uint32_t hi = k + 1 < K
              ? (uint32_t)delta[k + 1] + (accumulate ? row_u16<K>(ar[j], k + 1) : 0u) : 0u;
          out.w[k / 2] = __byte_perm(lo, hi, 0x5410);
        }
        store_row<K, VEC>(ap + s * step, valid, out);
        if (s + P < n) {
          load_row<K, VEC>(cp + (s + P) * step, valid, cr[j]);
          if (accumulate) load_row<K, VEC>(ap + (s + P) * step, valid, ar[j]);
        }
      }
    }
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
                 int P1, int P2, int accumulate, int vec, cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + SWEEP_WARPS - 1) / SWEEP_WARPS;
  const unsigned align = K >= 8 ? 16u : 2u * K;
  if (vec && (D % K != 0 || ((uintptr_t)C | (uintptr_t)acc) % align != 0)) {
    return (int)cudaErrorInvalidValue;  // the caller asked for a layout it lacks
  }
  if (vec) {
    path_sweep_kernel<K, true><<<blocks, 32 * SWEEP_WARPS, 0, stream>>>(
        (const int16_t*)C, (uint16_t*)acc, H, W, D, dx, dy, P1, P2, accumulate);
  } else {
    path_sweep_kernel<K, false><<<blocks, 32 * SWEEP_WARPS, 0, stream>>>(
        (const int16_t*)C, (uint16_t*)acc, H, W, D, dx, dy, P1, P2, accumulate);
  }
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
// onto (accumulate = 1). D <= 512. vec = 1: one access of 2K bytes per lane,
// which needs D % K == 0 and both pointers aligned to min(2K, 16) bytes
// (ops/cuda/sgm.py:sweep_vector_path); vec = 0: K scalar accesses.
int srcv_sgm_path_sweep(const void* C, void* acc, int H, int W, int D, int dx,
                        int dy, int P1, int P2, int accumulate, int vec,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SRCV_SWEEP(KK) \
  return launch_sweep<KK>(C, acc, H, W, D, dx, dy, P1, P2, accumulate, vec, s)
  switch (lanes_k(D)) {
    case 1: SRCV_SWEEP(1);
    case 2: SRCV_SWEEP(2);
    case 4: SRCV_SWEEP(4);
    case 8: SRCV_SWEEP(8);
    case 16: SRCV_SWEEP(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRCV_SWEEP
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
