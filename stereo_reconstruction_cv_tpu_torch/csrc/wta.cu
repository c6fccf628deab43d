// Winner-take-all over a cost volume plus one or two u16 delta volumes, as a
// pass of its own.
//
// Replaces the TPU kernels stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py
// _wta_volume (kernel _wta_kernel -> _wta_cell) and the probes of
// tools/micro_wta.py, wta_nat and wta_variant, which time layout and
// reduction variants of the same pass.
//
// Per pixel p of an (A, B) grid: S[d] = nd*C[p, d] + dsa[p, d] (+ dsb[p, d]),
// nd = 5 with one delta volume and 8 with two (the reference's rule); then
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
// volume at 3712x2160x128, 1.22 ms at 3.35 TB/s. The work is a handful of
// integer operations per cell and three or four warp reductions per pixel.
//
// Design: one warp per pixel with D across the lanes, K consecutive
// disparities per lane (K the smallest power of two with 32K >= D), as in
// sgm_sweep_wta's WTA. A block of WARPS warps takes a tile of bh x bw pixels
// (the probes' block shape) and its warps walk the tile, consecutive warps
// on consecutive pixels of a tile row. A simple kernel: no vector loads, no
// staging in shared memory.

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
int srcv_wta(const void* C, const void* dsa, const void* dsb, int A, int B,
             int D, int nd, int ur, int min_disp, int lg, int bh, int bw,
             int bfly, int shfl, void* disp, void* valid, void* best,
             void* mins, void* packed, void* stream) {
  if (A < 1 || B < 1 || D < 1 || D > 512 || bh < 1 || bw < 1 ||
      (long long)bh * bw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const WtaArgs g{(const int16_t*)C, (const uint16_t*)dsa, (const uint16_t*)dsb,
                  (float*)disp, (uint8_t*)valid, (int32_t*)best, (int32_t*)mins,
                  (float*)packed, A, B, D, nd, ur, min_disp, lg, bh, bw};
  cudaStream_t s = (cudaStream_t)stream;
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
