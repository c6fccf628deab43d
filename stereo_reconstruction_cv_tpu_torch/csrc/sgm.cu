// Semi-global path aggregation, and the last path sweep fused with
// winner-take-all.
//
// Replaces the TPU kernels of stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py
// that sgm_wta_pallas chains: _sweep_vertical / _sweep_vertical_tiled
// (U, UL, UR and their reverses), _sweep_hT (the forward horizontal path) and
// _sweep_hT_wta (the reverse horizontal path with _wta_cell fused); and those
// of sgm_aggregate_pallas (the full S volume), whose horizontal paths
// _sweep_horizontal runs: ops/cuda/sgm.py:sgm_aggregate_cuda sweeps all
// directions but one with srcv_sgm_path_sweep and the last with
// srcv_sgm_sweep_sum.
//
// srcv_sgm_path_sweep runs ONE direction r = (dx, dy) over the cropped cost
// volume C (H, W, D) int16 and writes, or adds onto, a u16 volume of that
// direction's (L - C) deltas. srcv_sgm_sweep_wta runs one more direction and
// reduces S = nd*C + deltas of every direction per pixel to the four WTA maps,
// so S never reaches device memory. srcv_sgm_sweep_sum runs the last
// direction the same way and stores S itself, int32 (H, W, D): the S-volume
// entry point's one pass over C and the delta volumes.
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
// the few paths of a 720p direction over all SMs. dp_step is unchanged.
//
// sweep_wta_kernel streams C and one or two delta volumes (2 + 2 per volume
// B/cell) and writes 13 B/pixel. Its first design loaded the next pixel's
// values with K scalar loads inside the current step (1.0 us a step at
// 720p, 0.17 of its bytes bound; 0.32 at 4K) and had lane 0 store four maps
// every step. Taking the path sweep's register ring for its three streams
// did not help: ablations on the card showed the loads, not the arithmetic,
// setting the pace (PERF.md, PR 5). It now keeps WTA_STAGES
// steps of its rows in flight with cp.async into a ring in shared memory,
// each step one commit group, and waits for exactly the oldest group; each
// lane reads back only the bytes it copied itself, so no barrier is needed.
// Rows are one access of 2K bytes (VEC, K >= 2); other shapes load each
// step's rows in the step (the general path, same kernel body). Blocks hold
// two warps. The WTA's four warp reductions per step do not feed the DP:
// the DP runs over WTA_BATCH steps and keeps their S rows, then their
// reductions are issued together and overlap. The four results of step s
// stay in lane s % 32 and the warp stores 32 steps at once. The numerics
// (dp_step, the packed key S*Dp + d, the uniqueness rule, the f32 subpixel)
// are unchanged.
//
// sweep_sum_kernel shares that ring (ring_fetch, rows_get) and dp_step, and
// replaces the WTA epilogue by a store of each step's S row: C, up to two
// delta volumes and S move 10 B/cell at most, once each. Before it, the S
// volume was assembled around eight path sweeps with torch ops (nd*C, then a
// u16 widen and an add per volume), about 7 GB of elementwise traffic at
// 720p x 128 and more than half of the route's 4.4 ms on an H100 80GB HBM3
// at 700 W (PERF.md). Rows go out as one 16-byte store per four values
// where K >= 4 (VEC), else smaller ones; streaming stores (__stcs) measured
// no faster. The kernel takes 0.45-0.50 ms there (0.63-0.70 of its bound)
// and the route 2.30 ms, with 7 path sweeps (PERF.md). The ring
// functions keep sweep_wta_kernel's registers: a struct holding the same
// state cost four of its instances 1-3 registers.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 29;  // no-neighbour sentinel; BIG + P1 cannot overflow

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

constexpr int SWEEP_WARPS = 2;  // paths (warps) per block of both sweep kernels

// Steps loaded ahead: a ring of P rows of C and of the delta volume per lane
// (2 * P * ceil(K/2) registers).
template <int K>
constexpr int RING_STEPS = K <= 2 ? 16 : (K <= 8 ? 8 : 4);

// CARRY: the block of rows continues a taller frame along dy != 0. A path
// that starts on the block's first row (in path order) takes its carry from
// carry_in, the (W, D) int32 L or lam of the row before the block, at the
// predecessor's column x - dx (zero where that leaves [0, W), as at a true
// path start), normalised to min 0; a path that ends on the block's last row
// writes its lam to carry_out at its own column. Either pointer may be null.
// Without CARRY the instance is the plain sweep.
template <int K, bool VEC, bool CARRY>
__global__ void __launch_bounds__(32 * SWEEP_WARPS)
path_sweep_kernel(const int16_t* __restrict__ C, uint16_t* __restrict__ acc,
                  const int32_t* __restrict__ carry_in, int32_t* __restrict__ carry_out,
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
  if constexpr (CARRY) {
    // y, x and the branch are the same for the whole warp (one path).
    const int xp = x - dx;
    if (carry_in && dy != 0 && y == (dy > 0 ? 0 : H - 1) && xp >= 0 && xp < W) {
      const int32_t* cin = carry_in + (size_t)xp * D + (size_t)lane * K;
      int v[K];
      int m = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = lane * K + k < D ? cin[k] : INT_MAX;
        m = min(m, v[k]);
      }
      m = __reduce_min_sync(FULL, m);
#pragma unroll
      for (int k = 0; k < K; ++k) lam[k] = lane * K + k < D ? v[k] - m : BIG;
    }
  }

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
  if constexpr (CARRY) {
    const int ye = y + (n - 1) * dy;
    if (carry_out && active && ye == (dy > 0 ? H - 1 : 0)) {
      int32_t* cout = carry_out + (size_t)(x + (n - 1) * dx) * D + (size_t)lane * K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane * K + k < D) cout[k] = lam[k];
      }
    }
  }
}

// sweep_wta_kernel's vector path keeps WTA_STAGES steps of C and the delta
// volumes in flight through a cp.async ring in shared memory (a register
// ring this deep left the loads waiting on each other). WTA_BATCH steps'
// S rows are kept in registers so that their WTA reductions are issued
// together; it divides 32, so the buffered maps are stored at a batch's end.
// WTA_MIN_BLOCKS caps the registers of K <= 8 at 128, eight blocks an SM.
// Chosen on the card (PERF.md, PR 5): with batch 4 and the cap the 4K time
// was the lowest or tied in every call and varied least between machines,
// and no instance spills (without the cap, small-K instances spill a few
// bytes).
template <int K>
constexpr int WTA_STAGES = K <= 4 ? 16 : (K == 8 ? 8 : 4);
template <int K>
constexpr int WTA_BATCH = K <= 4 ? 8 : 4;
template <int K>
constexpr int WTA_MIN_BLOCKS = K <= 8 ? 8 : 1;

// cp.async of one lane's row (2K bytes, 4 to 32) from global to shared memory.
template <int K>
__device__ __forceinline__ void copy_row_async(uint8_t* dst, const uint16_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (K == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else if constexpr (K == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
#pragma unroll
    for (int i = 0; i < K / 8; ++i) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(src + 8 * i));
    }
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fused sweep's rows of one lane along its path, K values each: C, then
// NV - 1 u16 delta volumes, at src[v] + s * step. With the ring (VEC, K >= 2)
// they stream through a cp.async ring of ST steps in shared memory (`mine`:
// this lane's bytes of its warp's ring, 64K bytes a row), one commit group
// per step, empty past the path's end or on idle lanes; rows_get asks for
// step s + ST - 1 and waits for exactly step s's group, and each lane reads
// back only the bytes it copied itself, so no barrier is needed. Otherwise
// rows_get loads step s's rows itself (the general path).
template <int K, int NV, int ST>
__device__ __forceinline__ void ring_fetch(uint8_t* mine, const uint16_t* const* src,
                                           long long step, int s, int n, bool active) {
  if (active && s < n) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      copy_row_async<K>(mine + ((s & (ST - 1)) * NV + v) * (64 * K), src[v] + s * step);
    }
  }
  copy_commit();
}

template <int K, bool VEC, int NV, int ST>
__device__ __forceinline__ void rows_get(Row<K> (&r)[NV], uint8_t* mine,
                                         const uint16_t* const* src, long long step, int s,
                                         int n, int nvalid, bool active) {
  if constexpr (VEC && K >= 2) {
    ring_fetch<K, NV, ST>(mine, src, step, s + ST - 1, n, active);
    copy_wait<ST - 1>();  // this lane's copies of step s have landed
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      load_row<K, true>(reinterpret_cast<const uint16_t*>(
                            mine + ((s & (ST - 1)) * NV + v) * (64 * K)), K, r[v]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int i = 0; i < (K + 1) / 2; ++i) r[v].w[i] = 0;
      if (active) load_row<K, VEC>(src[v] + s * step, nvalid, r[v]);
    }
  }
}

// Writes the buffered maps of steps sb .. sb + 31 (lane L holds step sb + L;
// lanes past the path's last step hold nothing and store nothing).
__device__ __forceinline__ void store_maps(float* __restrict__ disp, uint8_t* __restrict__ valid,
                                           int32_t* __restrict__ best_out,
                                           int32_t* __restrict__ mins_out, size_t o0,
                                           long long ostep, int sb, int last, int lane,
                                           int best, int minS, int sm1, int sp1, bool bad,
                                           int D, int min_disp) {
  if (sb + lane > last) return;
  // Parabolic subpixel, interior winners only, in f32 with the reference's
  // operation order and round-to-nearest intrinsics (no contraction, no
  // fast division).
  float dv = (float)best;
  if (best > 0 && best < D - 1) {
    const float denom = (float)max(sm1 + sp1 - 2 * minS, 1);
    dv = __fadd_rn(dv, __fdiv_rn((float)(sm1 - sp1), __fmul_rn(2.0f, denom)));
  } else {
    dv = __fadd_rn(dv, 0.0f);
  }
  const size_t o = o0 + (long long)(sb + lane) * ostep;
  disp[o] = __fadd_rn(dv, (float)min_disp);
  valid[o] = bad ? 0 : 1;
  best_out[o] = best;
  mins_out[o] = minS;
}

// TWO: a second delta volume dsb. VEC: D % K == 0 and aligned volumes, as
// path_sweep_kernel's; with K >= 2 it takes the cp.async ring, else each
// step loads its rows itself (the general path, same kernel body).
template <int K, bool VEC, bool TWO>
__global__ void __launch_bounds__(32 * SWEEP_WARPS, WTA_MIN_BLOCKS<K>)
sweep_wta_kernel(const int16_t* __restrict__ C, const uint16_t* __restrict__ dsa,
                 const uint16_t* __restrict__ dsb, float* __restrict__ disp,
                 uint8_t* __restrict__ valid, int32_t* __restrict__ best_out,
                 int32_t* __restrict__ mins_out, int H, int W, int D, int dx,
                 int dy, int nd, int P1, int P2, int ur, int min_disp, int lg) {
  constexpr bool RING = VEC && K >= 2;
  constexpr int NV = TWO ? 3 : 2;  // rows per step: C, dsa (, dsb)
  constexpr int ST = WTA_STAGES<K>;
  constexpr int P = WTA_BATCH<K>;
  constexpr int ROW = 64 * K;  // bytes of one warp's row
  __shared__ __align__(16) uint8_t ring[RING ? SWEEP_WARPS * ST * NV * ROW : 16];
  const int lane = threadIdx.x & 31;
  int y, x;
  if (!path_start(blockIdx.x * SWEEP_WARPS + (threadIdx.x >> 5), dx, dy, H, W, y, x)) return;
  const int n = path_steps(y, x, dx, dy, H, W);
  const long long ostep = (long long)dy * W + dx;  // pixels per path step
  const long long step = ostep * D;                // elements per path step
  const size_t o0 = (size_t)y * W + x;
  const size_t first = o0 * D + (size_t)lane * K;
  const uint16_t* src[3] = {reinterpret_cast<const uint16_t*>(C) + first, dsa + first,
                            TWO ? dsb + first : nullptr};
  const int nvalid = D - lane * K;  // with VEC, either <= 0 or >= K
  const bool active = nvalid > 0;
  uint8_t* mine = ring + (threadIdx.x >> 5) * (ST * NV * ROW) + lane * 2 * K;
  if constexpr (RING) {
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) ring_fetch<K, NV, ST>(mine, src, step, s, n, active);
  }

  int lam[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lam[k] = lane * K + k < D ? 0 : BIG;
  const int dmask = (1 << lg) - 1;
  // This lane's buffered results (of step s with s % 32 == lane).
  int hb = 0, hm = 0, hsm1 = 0, hsp1 = 0;
  bool hbad = false;

  for (int s0 = 0; s0 < n; s0 += P) {
    // The DP over P steps, keeping each step's S row. The WTA of those
    // steps follows: its reductions do not feed the DP, so issued together
    // they overlap instead of lengthening every step's chain.
    int S[P][K];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = s0 + j;
      if (s < n) {
        Row<K> r[NV];
        rows_get<K, VEC, NV, ST>(r, mine, src, step, s, n, nvalid, active);
        int c[K], delta[K];
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = row_s16<K>(r[0], k);
        dp_step<K>(lam, c, delta, lane, D, P1, P2);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          S[j][k] = nd * c[k] + (int)row_u16<K>(r[1], k) + delta[k];
          if constexpr (TWO) S[j][k] += (int)row_u16<K>(r[2], k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) S[j][k] = 0;
      }
    }
    // Packed key S*Dp + d: one min gives minS and the smallest-d argmin.
    // Written without branches, so the P steps' work interleaves.
    int key[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      key[j] = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        key[j] = min(key[j], lane * K + k < D ? (S[j][k] << lg) + lane * K + k : INT_MAX);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) key[j] = __reduce_min_sync(FULL, key[j]);
    // Uniqueness: invalid if some |d - best| > 1 has S*(100 - ur) < minS*100.
    // S[best -+ 1] come from the one lane that holds each (a padding entry
    // can match best + 1 = D only, whose S the subpixel step does not use).
    bool bad[P];
    unsigned sm1[P], sp1[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int best = key[j] & dmask;
      const int thr = (key[j] >> lg) * 100;
      bool b = false;
      unsigned m1 = 0, p1 = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane * K + k - best;  // d - best
        b |= (lane * K + k < D) & ((unsigned)(e + 1) > 2u) & (S[j][k] * (100 - ur) < thr);
        m1 = e == -1 ? (unsigned)S[j][k] : m1;
        p1 = e == 1 ? (unsigned)S[j][k] : p1;
      }
      bad[j] = b;
      sm1[j] = m1;
      sp1[j] = p1;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      bad[j] = __any_sync(FULL, bad[j]);
      sm1[j] = __reduce_add_sync(FULL, sm1[j]);  // one lane holds each neighbour
      sp1[j] = __reduce_add_sync(FULL, sp1[j]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (lane == ((s0 + j) & 31)) {
        hb = key[j] & dmask;
        hm = key[j] >> lg;
        hsm1 = (int)sm1[j];
        hsp1 = (int)sp1[j];
        hbad = bad[j];
      }
    }
    // P divides 32: a group of 32 steps ends with a batch or with the path.
    const int last = min(s0 + P, n) - 1;
    if (((last + 1) & 31) == 0 || last == n - 1) {
      store_maps(disp, valid, best_out, mins_out, o0, ostep, last & ~31, last, lane, hb, hm,
                 hsm1, hsp1, hbad, D, min_disp);
    }
  }
  if constexpr (RING) copy_wait<0>();  // no copy outlives the block
}

// Steps of sweep_sum_kernel's DP issued between two loop tests (unrolled);
// the S rows of one step are stored while the next step's DP runs.
constexpr int SUM_BATCH = 4;

// One step's S row, v[k] for d = lane * K + k, stored at p (or added onto
// what p holds): 16-byte stores where VEC and K >= 4 (p 16-byte aligned),
// 8-byte where VEC and K == 2, else the first `valid` values one by one.
template <int K, bool VEC>
__device__ __forceinline__ void store_sum_row(int32_t* p, int valid, int (&v)[K], int accumulate) {
  if constexpr (VEC && K >= 4) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      int4* q = reinterpret_cast<int4*>(p) + i;
      int4 o = make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      if (accumulate) {
        const int4 a = *q;
        o = make_int4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
      }
      *q = o;
    }
  } else if constexpr (VEC && K == 2) {
    int2* q = reinterpret_cast<int2*>(p);
    int2 o = make_int2(v[0], v[1]);
    if (accumulate) {
      const int2 a = *q;
      o = make_int2(o.x + a.x, o.y + a.y);
    }
    *q = o;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < valid) p[k] = v[k] + (accumulate ? p[k] : 0);
    }
  }
}

// The last direction as sweep_wta_kernel sweeps it (the same ring and DP),
// storing S = nd*C + the NVOL u16 volumes + its deltas per step, int32
// (H, W, D); accumulate adds onto S instead (a later pass of a long
// direction list). VEC as for sweep_wta_kernel, with S aligned to
// min(4K, 16) bytes.
template <int K, bool VEC, int NVOL>
__global__ void __launch_bounds__(32 * SWEEP_WARPS, WTA_MIN_BLOCKS<K>)
sweep_sum_kernel(const int16_t* __restrict__ C, const uint16_t* __restrict__ dsa,
                 const uint16_t* __restrict__ dsb, int32_t* __restrict__ S, int H, int W,
                 int D, int dx, int dy, int nd, int P1, int P2, int accumulate) {
  constexpr bool RING = VEC && K >= 2;
  constexpr int NV = 1 + NVOL;  // rows per step: C (, dsa (, dsb))
  constexpr int ST = WTA_STAGES<K>;
  constexpr int ROW = 64 * K;  // bytes of one warp's row
  __shared__ __align__(16) uint8_t ring[RING ? SWEEP_WARPS * ST * NV * ROW : 16];
  const int lane = threadIdx.x & 31;
  int y, x;
  if (!path_start(blockIdx.x * SWEEP_WARPS + (threadIdx.x >> 5), dx, dy, H, W, y, x)) return;
  const int n = path_steps(y, x, dx, dy, H, W);
  const long long step = ((long long)dy * W + dx) * D;  // elements per path step
  const size_t first = ((size_t)y * W + x) * D + (size_t)lane * K;
  const uint16_t* src[3] = {reinterpret_cast<const uint16_t*>(C) + first,
                            NVOL >= 1 ? dsa + first : nullptr, NVOL >= 2 ? dsb + first : nullptr};
  const int nvalid = D - lane * K;  // with VEC, either <= 0 or >= K
  const bool active = nvalid > 0;
  uint8_t* mine = ring + (threadIdx.x >> 5) * (ST * NV * ROW) + lane * 2 * K;
  if constexpr (RING) {
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) ring_fetch<K, NV, ST>(mine, src, step, s, n, active);
  }
  int32_t* sp = S + first;

  int lam[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lam[k] = lane * K + k < D ? 0 : BIG;
  for (int s0 = 0; s0 < n; s0 += SUM_BATCH) {
#pragma unroll
    for (int j = 0; j < SUM_BATCH; ++j) {
      const int s = s0 + j;
      if (s < n) {
        Row<K> r[NV];
        rows_get<K, VEC, NV, ST>(r, mine, src, step, s, n, nvalid, active);
        int c[K], delta[K];
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = row_s16<K>(r[0], k);
        dp_step<K>(lam, c, delta, lane, D, P1, P2);
        if (active) {
          int v[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            v[k] = nd * c[k] + delta[k];
            if constexpr (NVOL >= 1) v[k] += (int)row_u16<K>(r[1], k);
            if constexpr (NVOL >= 2) v[k] += (int)row_u16<K>(r[2], k);
          }
          store_sum_row<K, VEC>(sp + s * step, nvalid, v, accumulate);
        }
      }
    }
  }
  if constexpr (RING) copy_wait<0>();  // no copy outlives the block
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

template <int K, bool VEC, bool CARRY>
void launch_sweep_instance(const void* C, void* acc, const void* cin, void* cout, int H,
                           int W, int D, int dx, int dy, int P1, int P2, int accumulate,
                           cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + SWEEP_WARPS - 1) / SWEEP_WARPS;
  path_sweep_kernel<K, VEC, CARRY><<<blocks, 32 * SWEEP_WARPS, 0, stream>>>(
      (const int16_t*)C, (uint16_t*)acc, (const int32_t*)cin, (int32_t*)cout, H, W, D, dx,
      dy, P1, P2, accumulate);
}

template <int K>
int launch_sweep(const void* C, void* acc, const void* cin, void* cout, int H, int W, int D,
                 int dx, int dy, int P1, int P2, int accumulate, int vec,
                 cudaStream_t stream) {
  const unsigned align = K >= 8 ? 16u : 2u * K;
  if (vec && (D % K != 0 || ((uintptr_t)C | (uintptr_t)acc) % align != 0)) {
    return (int)cudaErrorInvalidValue;  // the caller asked for a layout it lacks
  }
  if ((cin || cout) && dy == 0) return (int)cudaErrorInvalidValue;  // rows are whole
#define SRCV_SWEEP_INSTANCE(VV, CC) \
  launch_sweep_instance<K, VV, CC>(C, acc, cin, cout, H, W, D, dx, dy, P1, P2, accumulate, stream)
  const bool carry = cin || cout;
  if (vec) {
    if (carry) SRCV_SWEEP_INSTANCE(true, true); else SRCV_SWEEP_INSTANCE(true, false);
  } else {
    if (carry) SRCV_SWEEP_INSTANCE(false, true); else SRCV_SWEEP_INSTANCE(false, false);
  }
#undef SRCV_SWEEP_INSTANCE
  return (int)cudaGetLastError();
}

template <int K, bool VEC, bool TWO>
void launch_wta_instance(const void* C, const void* dsa, const void* dsb, void* disp,
                         void* valid, void* best, void* mins, int H, int W, int D,
                         int dx, int dy, int nd, int P1, int P2, int ur, int min_disp,
                         int lg, cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + SWEEP_WARPS - 1) / SWEEP_WARPS;
  sweep_wta_kernel<K, VEC, TWO><<<blocks, 32 * SWEEP_WARPS, 0, stream>>>(
      (const int16_t*)C, (const uint16_t*)dsa, (const uint16_t*)dsb, (float*)disp,
      (uint8_t*)valid, (int32_t*)best, (int32_t*)mins, H, W, D, dx, dy, nd, P1, P2,
      ur, min_disp, lg);
}

template <int K>
int launch_wta(const void* C, const void* dsa, const void* dsb, void* disp,
               void* valid, void* best, void* mins, int H, int W, int D, int dx,
               int dy, int nd, int P1, int P2, int ur, int min_disp, int lg, int vec,
               cudaStream_t stream) {
  const unsigned align = K >= 8 ? 16u : 2u * K;
  if (vec && (D % K != 0 ||
              ((uintptr_t)C | (uintptr_t)dsa | (uintptr_t)dsb) % align != 0)) {
    return (int)cudaErrorInvalidValue;  // the caller asked for a layout it lacks
  }
#define SRCV_WTA_INSTANCE(VV, TT)                                                  \
  launch_wta_instance<K, VV, TT>(C, dsa, dsb, disp, valid, best, mins, H, W, D, dx, \
                                 dy, nd, P1, P2, ur, min_disp, lg, stream)
  if (vec) {
    if (dsb) SRCV_WTA_INSTANCE(true, true); else SRCV_WTA_INSTANCE(true, false);
  } else {
    if (dsb) SRCV_WTA_INSTANCE(false, true); else SRCV_WTA_INSTANCE(false, false);
  }
#undef SRCV_WTA_INSTANCE
  return (int)cudaGetLastError();
}

template <int K, bool VEC, int NVOL>
void launch_sum_instance(const void* C, const void* dsa, const void* dsb, void* S, int H,
                         int W, int D, int dx, int dy, int nd, int P1, int P2,
                         int accumulate, cudaStream_t stream) {
  const int blocks = (num_paths(dx, dy, H, W) + SWEEP_WARPS - 1) / SWEEP_WARPS;
  sweep_sum_kernel<K, VEC, NVOL><<<blocks, 32 * SWEEP_WARPS, 0, stream>>>(
      (const int16_t*)C, (const uint16_t*)dsa, (const uint16_t*)dsb, (int32_t*)S, H, W, D,
      dx, dy, nd, P1, P2, accumulate);
}

template <int K>
int launch_sum(const void* C, const void* dsa, const void* dsb, void* S, int H, int W,
               int D, int dx, int dy, int nd, int P1, int P2, int accumulate, int vec,
               cudaStream_t stream) {
  const unsigned align = K >= 8 ? 16u : 2u * K;
  const unsigned salign = K >= 4 ? 16u : 4u * K;
  if (dsb && !dsa) return (int)cudaErrorInvalidValue;
  if (vec && (D % K != 0 ||
              ((uintptr_t)C | (uintptr_t)dsa | (uintptr_t)dsb) % align != 0 ||
              (uintptr_t)S % salign != 0)) {
    return (int)cudaErrorInvalidValue;  // the caller asked for a layout it lacks
  }
#define SRCV_SUM_INSTANCE(VV, NN)                                                   \
  launch_sum_instance<K, VV, NN>(C, dsa, dsb, S, H, W, D, dx, dy, nd, P1, P2, accumulate, \
                                 stream)
  const int nvol = dsb ? 2 : (dsa ? 1 : 0);
  if (vec) {
    if (nvol == 2) SRCV_SUM_INSTANCE(true, 2);
    else if (nvol == 1) SRCV_SUM_INSTANCE(true, 1);
    else SRCV_SUM_INSTANCE(true, 0);
  } else {
    if (nvol == 2) SRCV_SUM_INSTANCE(false, 2);
    else if (nvol == 1) SRCV_SUM_INSTANCE(false, 1);
    else SRCV_SUM_INSTANCE(false, 0);
  }
#undef SRCV_SUM_INSTANCE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C: (H, W, D) int16; acc: (H, W, D) u16, written (accumulate = 0) or added
// onto (accumulate = 1). D <= 512. vec = 1: one access of 2K bytes per lane,
// which needs D % K == 0 and both pointers aligned to min(2K, 16) bytes
// (ops/cuda/sgm.py:sweep_vector_path); vec = 0: K scalar accesses.
// carry_in, carry_out: (W, D) int32 rows before and after the block (dy != 0
// only; path_sweep_kernel), or null.
int srcv_sgm_path_sweep(const void* C, void* acc, const void* carry_in, void* carry_out,
                        int H, int W, int D, int dx, int dy, int P1, int P2,
                        int accumulate, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SRCV_SWEEP(KK)                                                                  \
  return launch_sweep<KK>(C, acc, carry_in, carry_out, H, W, D, dx, dy, P1, P2, accumulate, \
                          vec, s)
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
// best i32, minS i32. lg = log2 of the power of two >= D. vec as for
// srcv_sgm_path_sweep, over C, dsa and dsb.
int srcv_sgm_sweep_wta(const void* C, const void* dsa, const void* dsb,
                       void* disp, void* valid, void* best, void* mins, int H,
                       int W, int D, int dx, int dy, int nd, int P1, int P2,
                       int ur, int min_disp, int lg, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SRCV_WTA(KK)                                                          \
  return launch_wta<KK>(C, dsa, dsb, disp, valid, best, mins, H, W, D, dx, dy, \
                        nd, P1, P2, ur, min_disp, lg, vec, s)
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

// Last direction with S stored: S (H, W, D) int32 = nd*C + dsa + dsb + the
// direction's deltas, written (accumulate = 0) or added onto (1). dsa, dsb:
// u16 delta volumes, either may be null (dsb only with dsa). vec as for
// srcv_sgm_sweep_wta, with S also aligned to min(4K, 16) bytes.
int srcv_sgm_sweep_sum(const void* C, const void* dsa, const void* dsb, void* S, int H,
                       int W, int D, int dx, int dy, int nd, int P1, int P2,
                       int accumulate, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SRCV_SUM(KK) \
  return launch_sum<KK>(C, dsa, dsb, S, H, W, D, dx, dy, nd, P1, P2, accumulate, vec, s)
  switch (lanes_k(D)) {
    case 1: SRCV_SUM(1);
    case 2: SRCV_SUM(2);
    case 4: SRCV_SUM(4);
    case 8: SRCV_SUM(8);
    case 16: SRCV_SUM(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRCV_SUM
}

}  // extern "C"
