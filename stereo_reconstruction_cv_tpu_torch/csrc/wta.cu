// Winner-take-all over a cost volume plus zero, one or two u16 delta volumes,
// as a pass of its own. With no delta volume it is block matching's WTA over
// the cost volume alone (SGBMConfig.num_directions = 0), the one main-path
// use of this file.
//
// Replaces the TPU kernels stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py
// _wta_volume (kernel _wta_kernel -> _wta_cell) and the probes of
// tools/micro_wta.py, wta_nat and wta_variant, which time layout and
// reduction variants of the same pass.
//
// Per pixel p of an (A, B) grid: S[d] = nd*C[p, d] + dsa[p, d] (+ dsb[p, d]),
// nd = 5 with one delta volume and 8 with two (the reference's rule), or
// S[d] = C[p, d] (nd = 1) with none; then
// the packed-key argmin (key = S*Dp + d, Dp = 2^lg >= D, so ties go to the
// smaller d), OpenCV's uniqueness test and the parabolic subpixel in the f32
// order of wta_maps: best + frac + min_disp, with precise division.
//
// srcv_wta writes either the four (A, B) maps of _wta_volume (disp f32,
// valid u8, best i32, minS i32), or the packed (A, B, 8) f32 array of the
// probes: lanes 0-3 disp, 1 - bad, best, minS; lanes 4-7 zero. The maps form
// tests uniqueness as _wta_cell does, by a vote: bad if some d with
// |d - best| > 1 has S*(100 - r) < minS*100. The packed form tests it as the
// probes do, by a second reduction: the minimum of S over those d (when
// there is none, D <= 3, the pixel is valid; the probes' int32 sentinel
// wraps there). Two knobs of the packed form mirror the probes' variants and
// change no bit of the output:
//   bfly  warp minima and sums by an __shfl_xor_sync butterfly
//         (wta_variant's _butterfly_min / _butterfly_sum) instead of
//         redux.sync (__reduce_min_sync, wta_nat's native jnp.min / jnp.sum);
//   shfl  S[best - 1] and S[best + 1] read by one __shfl_sync each from the
//         lane that holds them (wta_variant's use_dot: extraction other than
//         by a reduction) instead of a masked warp sum.
//
// What bounds it on an H100: bytes. It reads 2 + 2*nvol bytes per cell and
// writes 13 (maps) or 32 (packed) bytes per pixel: 4.1 GB with one delta
// volume at 3712x2160x128, 1.22 ms at 3.35 TB/s; with none at 720x1216x64,
// 123.5 MB, 0.037 ms. The work is a handful of
// integer operations per cell and three or four warp reductions per pixel.
//
// Design, with delta volumes: one warp per pixel with D across the lanes, K
// consecutive disparities per lane (K the smallest power of two with 32K >=
// D), as in sgm_sweep_wta's WTA. A block of WARPS warps takes a tile of bh x
// bw pixels (the probes' block shape) and its warps walk the tile,
// consecutive warps on consecutive pixels of a tile row. A simple kernel: no
// vector loads, no staging in shared memory.
//
// Design, with none (wta_cost_kernel, maps form only): C is the only volume,
// 2 bytes a cell, so the pass reads 2 B a cell and writes 13 B a pixel, and a
// pixel's row of D int16 costs is short (128 B at D = 64). G lanes take one
// pixel (G the smallest power of two with 8G >= D, at most 32) and a warp
// 32/G consecutive pixels; lane g of a group holds the chunks of 8
// consecutive disparities that start at 8*(g + G*j), j < J (J = 2 only past
// D = 256). Where D % 8 == 0 and C is 16-byte aligned each chunk is one
// 16-byte load, so at D = 64 a warp reads 4 pixels' 512 contiguous bytes at
// once; else element by element. The group's minimum, vote and the two
// neighbour reads are butterflies over its G lanes. The bh x bw tile and the
// two knobs do not apply: the warps stride over the pixels in order.
// Variants timed on an H100 at 720x1216x64 (L2-cold, each bit-equal to
// this design's 0.085 ms): the minimum over the far disparities in place
// of the vote (S*(100 - ur) grows with S, so the smallest far S decides)
// 0.075; with it, 16 or 32 costs a lane 0.066 / 0.063; a select tree for
// the neighbour reads 0.068-0.257. Not taken yet: the one cell that runs
// this form is host-bound (the card idles ~81% of it), so 0.02 ms a frame
// moves no end-to-end number; take the 32-costs form once the host no
// longer sets that cell's pace.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;          // warps (pixels in flight) per block
constexpr int NO_FAR = 1 << 30;   // far-minimum sentinel: above any S

struct WtaArgs {
  const int16_t* C;
  const uint16_t* dsa;
  const uint16_t* dsb;  // may be null
  float* disp;          // maps form
  uint8_t* valid;
  int32_t* best;
  int32_t* mins;
  float* packed;        // packed form (then the four maps are null)
  int A, B, D, nd, ur, min_disp, lg, bh, bw;
};

template <bool BFLY>
__device__ __forceinline__ int warp_min(int v) {
  if constexpr (BFLY) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
  } else {
    return __reduce_min_sync(FULL, v);
  }
}

template <bool BFLY>
__device__ __forceinline__ int warp_sum(int v) {
  if constexpr (BFLY) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
  } else {
    return __reduce_add_sync(FULL, v);
  }
}

// S[d] for the warp's lanes; one element of d's row is held by exactly one lane.
template <int K, bool BFLY, bool SHFL>
__device__ __forceinline__ int extract(const int (&s)[K], int d, int lane) {
  if constexpr (SHFL) {
    int v = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == d % K) v = s[k];
    return __shfl_sync(FULL, v, d / K);
  } else {
    int v = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane * K + k == d) v = s[k];
    return warp_sum<BFLY>(v);
  }
}

template <int K, bool BFLY, bool SHFL, bool PACKED>
__global__ void __launch_bounds__(32 * WARPS) wta_kernel(const WtaArgs g) {
  const int lane = threadIdx.x & 31;
  const int ntb = (g.B + g.bw - 1) / g.bw;
  const int ta = blockIdx.x / ntb, tb = blockIdx.x % ntb;
  const int dmask = (1 << g.lg) - 1;
  for (int i = threadIdx.x >> 5; i < g.bh * g.bw; i += WARPS) {
    const int a = ta * g.bh + i / g.bw, b = tb * g.bw + i % g.bw;
    if (a >= g.A || b >= g.B) continue;  // uniform across the warp
    const size_t p = (size_t)a * g.B + b;
    const size_t base = p * g.D;
    int s[K];
    int key = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      s[k] = 0;
      if (d < g.D) {
        s[k] = g.nd * (int)g.C[base + d] + (int)g.dsa[base + d] +
               (g.dsb ? (int)g.dsb[base + d] : 0);
        key = min(key, s[k] * (1 << g.lg) + d);
      }
    }
    key = warp_min<BFLY>(key);
    const int best = key & dmask;
    const int minS = key >> g.lg;  // arithmetic: exact for negative S too

    bool bad;
    if constexpr (PACKED) {
      int far = NO_FAR;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        if (d < g.D && abs(d - best) > 1) far = min(far, s[k]);
      }
      far = warp_min<BFLY>(far);
      bad = far != NO_FAR && far * (100 - g.ur) < minS * 100;
    } else {
      bool q = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        if (d < g.D && abs(d - best) > 1 && s[k] * (100 - g.ur) < minS * 100) q = true;
      }
      bad = __any_sync(FULL, q);
    }
    const int Sm1 = extract<K, BFLY, SHFL>(s, max(best - 1, 0), lane);
    const int Sp1 = extract<K, BFLY, SHFL>(s, min(best + 1, g.D - 1), lane);

    // Parabolic subpixel, interior winners only, in f32 with the reference's
    // operation order and round-to-nearest intrinsics (no contraction, no
    // fast division). Every lane holds the same values.
    float dv = (float)best;
    if (best > 0 && best < g.D - 1) {
      const float denom = (float)max(Sm1 + Sp1 - 2 * minS, 1);
      dv = __fadd_rn(dv, __fdiv_rn((float)(Sm1 - Sp1), __fmul_rn(2.0f, denom)));
    } else {
      dv = __fadd_rn(dv, 0.0f);
    }
    dv = __fadd_rn(dv, (float)g.min_disp);
    if constexpr (PACKED) {
      if (lane < 8) {
        float v = 0.0f;
        if (lane == 0) v = dv;
        if (lane == 1) v = bad ? 0.0f : 1.0f;
        if (lane == 2) v = (float)best;
        if (lane == 3) v = (float)minS;
        g.packed[p * 8 + lane] = v;
      }
    } else {
      if (lane == 0) g.disp[p] = dv;
      if (lane == 1) g.valid[p] = bad ? 0 : 1;
      if (lane == 2) g.best[p] = best;
      if (lane == 3) g.mins[p] = minS;
    }
  }
}

// Butterflies over the aligned groups of G lanes of a warp (every lane takes part).
template <int G>
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int G>
__device__ __forceinline__ int group_or(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
  return v;
}

// S = C: the WTA of block matching, the four maps (see Design, with none).
template <int G, int J, bool VEC>
__global__ void __launch_bounds__(32 * WARPS) wta_cost_kernel(const WtaArgs g) {
  constexpr int PIX = 32 / G;  // pixels a warp takes at a step
  const int lane = threadIdx.x & 31, gl = lane % G;
  const long long n = (long long)g.A * g.B;
  const long long step = (long long)gridDim.x * WARPS * PIX;
  const int dmask = (1 << g.lg) - 1;
  // The loop's bounds are uniform across the warp, so every lane reaches
  // every butterfly; lanes past the last pixel compute on zeros and store
  // nothing.
  for (long long base = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PIX; base < n;
       base += step) {
    const long long p = base + lane / G;
    const bool active = p < n;
    const int16_t* row = g.C + (active ? p : 0) * g.D;
    int s[J][8];
    int key = INT_MAX;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d0 = 8 * (gl + G * j);
      if constexpr (VEC) {
        int4 raw = make_int4(0, 0, 0, 0);
        if (active && d0 < g.D) raw = *reinterpret_cast<const int4*>(row + d0);
        const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // little-endian: the lower d in the low half
          s[j][2 * q] = (int)(int16_t)(w[q] & 0xffff);
          s[j][2 * q + 1] = w[q] >> 16;  // arithmetic: sign-extends the high half
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) s[j][k] = (active && d0 + k < g.D) ? (int)row[d0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (d0 + k < g.D) key = min(key, s[j][k] * (1 << g.lg) + d0 + k);
    }
    key = group_min<G>(key);
    const int best = key & dmask;
    const int minS = key >> g.lg;  // arithmetic: exact for negative S too
    const int lim = minS * 100, um = 100 - g.ur;
    const int dm1 = max(best - 1, 0), dp1 = min(best + 1, g.D - 1);
    int q = 0, Sm1 = 0, Sp1 = 0;  // one lane of the group holds each of dm1, dp1
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = 8 * (gl + G * j) + k;
        if (d < g.D && abs(d - best) > 1 && s[j][k] * um < lim) q = 1;
        if (d == dm1) Sm1 = s[j][k];
        if (d == dp1) Sp1 = s[j][k];
      }
    }
    const bool bad = group_or<G>(q) != 0;
    Sm1 = group_sum<G>(Sm1);
    Sp1 = group_sum<G>(Sp1);

    // Parabolic subpixel as in wta_kernel.
    float dv = (float)best;
    if (best > 0 && best < g.D - 1) {
      const float denom = (float)max(Sm1 + Sp1 - 2 * minS, 1);
      dv = __fadd_rn(dv, __fdiv_rn((float)(Sm1 - Sp1), __fmul_rn(2.0f, denom)));
    } else {
      dv = __fadd_rn(dv, 0.0f);
    }
    dv = __fadd_rn(dv, (float)g.min_disp);
    if (active && gl == 0) {
      g.disp[p] = dv;
      g.valid[p] = bad ? 0 : 1;
      g.best[p] = best;
      g.mins[p] = minS;
    }
  }
}

constexpr long long COST_BLOCKS = 4096;  // the grid's cap; warps then stride

template <int G, int J>
int launch_cost(const WtaArgs& g, bool vec, cudaStream_t stream) {
  const long long per_block = (long long)WARPS * (32 / G);
  const long long blocks = ((long long)g.A * g.B + per_block - 1) / per_block;
  const unsigned grid = (unsigned)(blocks < COST_BLOCKS ? blocks : COST_BLOCKS);
  if (vec)
    wta_cost_kernel<G, J, true><<<grid, 32 * WARPS, 0, stream>>>(g);
  else
    wta_cost_kernel<G, J, false><<<grid, 32 * WARPS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int K, bool BFLY, bool SHFL, bool PACKED>
int launch(const WtaArgs& g, cudaStream_t stream) {
  const long long tiles = (long long)((g.A + g.bh - 1) / g.bh) * ((g.B + g.bw - 1) / g.bw);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  wta_kernel<K, BFLY, SHFL, PACKED><<<(unsigned)tiles, 32 * WARPS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const WtaArgs& g, int bfly, int shfl, cudaStream_t stream) {
  if (!g.packed) return launch<K, false, false, false>(g, stream);
  if (bfly) return shfl ? launch<K, true, true, true>(g, stream) : launch<K, true, false, true>(g, stream);
  return shfl ? launch<K, false, true, true>(g, stream) : launch<K, false, false, true>(g, stream);
}

}  // namespace

extern "C" {

// C, dsa, dsb: (A, B, D) int16 / u16 / u16 (dsb may be null); nd = 5 or 8.
// packed null: the four (A, B) maps disp f32, valid u8, best i32, minS i32;
// packed not null: the (A, B, 8) f32 array (the four maps unused). One block
// per bh x bw tile of pixels. lg = log2 of the power of two >= D; D <= 512.
// dsa null (then dsb null, nd = 1, packed null): S = C, by wta_cost_kernel;
// bh, bw, bfly and shfl are then unused.
int srcv_wta(const void* C, const void* dsa, const void* dsb, int A, int B,
             int D, int nd, int ur, int min_disp, int lg, int bh, int bw,
             int bfly, int shfl, void* disp, void* valid, void* best,
             void* mins, void* packed, void* stream) {
  if (A < 1 || B < 1 || D < 1 || D > 512 || bh < 1 || bw < 1 ||
      (long long)bh * bw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (!dsa && (dsb || nd != 1 || packed)) return (int)cudaErrorInvalidValue;
  const WtaArgs g{(const int16_t*)C, (const uint16_t*)dsa, (const uint16_t*)dsb,
                  (float*)disp, (uint8_t*)valid, (int32_t*)best, (int32_t*)mins,
                  (float*)packed, A, B, D, nd, ur, min_disp, lg, bh, bw};
  cudaStream_t s = (cudaStream_t)stream;
  if (!dsa) {
    const bool vec = D % 8 == 0 && (uintptr_t)C % 16 == 0;
    int gs = 1;
    while (8 * gs < D && gs < 32) gs *= 2;
    switch (gs) {
      case 1: return launch_cost<1, 1>(g, vec, s);
      case 2: return launch_cost<2, 1>(g, vec, s);
      case 4: return launch_cost<4, 1>(g, vec, s);
      case 8: return launch_cost<8, 1>(g, vec, s);
      case 16: return launch_cost<16, 1>(g, vec, s);
      default: return D > 256 ? launch_cost<32, 2>(g, vec, s) : launch_cost<32, 1>(g, vec, s);
    }
  }
  int k = 1;
  while (32 * k < D) k *= 2;
  switch (k) {
    case 1: return launch_k<1>(g, bfly, shfl, s);
    case 2: return launch_k<2>(g, bfly, shfl, s);
    case 4: return launch_k<4>(g, bfly, shfl, s);
    case 8: return launch_k<8>(g, bfly, shfl, s);
    case 16: return launch_k<16>(g, bfly, shfl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
