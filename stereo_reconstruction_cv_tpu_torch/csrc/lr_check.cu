// Left-right consistency check (OpenCV disp12MaxDiff) from the WTA maps.
//
// Replaces the TPU kernel stereo_reconstruction_cv_tpu/ops/pallas/lr_pallas.py
// lr_check_maps_pallas (kernel _lr_kernel), which computes the right-view
// winner map as a gather over D rotated copies of the maps because a TPU has
// no fast scatter. On a GPU the scatter is the natural form, as in OpenCV:
//
//   pass 1: every left pixel x (full-frame column x0 + xc) scatters its packed
//           winner minS*Dq + best into right column x - min_disp - best with
//           atomicMin. Dq is the power of two >= D + 1, so one min picks the
//           smallest winning cost and, on ties, the smallest d: the result is
//           bit-identical to the gather form whatever the order of atomics.
//           Every pixel scatters, uniqueness-invalid ones included, as the
//           reference does.
//   pass 2: each left pixel checks the floor and the ceil of its subpixel
//           disparity; a check passes when the partner is off-image, has no
//           winner, or agrees within disp12MaxDiff. The pixel is kept if
//           either check passes.
//
// What bounds it on an H100: a few bytes per pixel of (H, W) maps, so it is
// bound by launch latency and atomics traffic, not by the card's bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Byte pattern 0x7f of the cudaMemsetAsync fill: larger than any packed key
// (the caller bounds minS*Dq + best below it).
constexpr int32_t NO_PARTNER = 0x7f7f7f7f;
constexpr int THREADS = 256;

__global__ void lr_scatter_kernel(const int32_t* __restrict__ best,
                                  const int32_t* __restrict__ mins,
                                  int32_t* __restrict__ pk, int H, int Wc,
                                  int D, int min_disp, int Dq) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)H * Wc) return;
  const int y = (int)(i / Wc);
  const int xc = (int)(i % Wc);
  const int b = best[i];
  if (b < 0 || b >= D) return;  // not a winner index: nothing to scatter
  const int x0 = min_disp + D;
  const int xr = x0 + xc - min_disp - b;  // >= 1 since b < D
  atomicMin(&pk[(size_t)y * (x0 + Wc) + xr], mins[i] * Dq + b);
}

__device__ __forceinline__ bool partner_agrees(const int32_t* __restrict__ pkrow,
                                               int x, int di, int Wf, int Dq,
                                               int min_disp, int max_diff) {
  const int xr = x - di;
  if (xr < 0 || xr >= Wf) return true;
  const int p = pkrow[xr];
  if (p == NO_PARTNER) return true;
  const int dR = (p & (Dq - 1)) + min_disp;
  return abs(dR - di) <= max_diff;
}

__global__ void lr_keep_kernel(const int32_t* __restrict__ pk,
                               const float* __restrict__ disp,
                               uint8_t* __restrict__ keep, int H, int Wc,
                               int x0, int min_disp, int Dq, int max_diff) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)H * Wc) return;
  const int y = (int)(i / Wc);
  const int x = x0 + (int)(i % Wc);
  const int Wf = x0 + Wc;
  const int32_t* pkrow = pk + (size_t)y * Wf;
  const float dv = disp[i];
  const int df = (int)floorf(dv);
  const int dc = (int)ceilf(dv);
  keep[i] = partner_agrees(pkrow, x, df, Wf, Dq, min_disp, max_diff) ||
            partner_agrees(pkrow, x, dc, Wf, Dq, min_disp, max_diff);
}

}  // namespace

extern "C" {

// best, minS: (H, Wc) int32; disp: (H, Wc) f32; pk: (H, min_disp + D + Wc)
// int32 scratch; keep: (H, Wc) u8 out.
int srcv_lr_check(const void* best, const void* mins, const void* disp,
                  void* pk, void* keep, int H, int Wc, int D, int min_disp,
                  int max_diff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int x0 = min_disp + D;
  int Dq = 1;
  while (Dq < D + 1) Dq *= 2;
  cudaError_t err = cudaMemsetAsync(pk, 0x7f, sizeof(int32_t) * (size_t)H * (x0 + Wc), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((size_t)H * Wc + THREADS - 1) / THREADS);
  lr_scatter_kernel<<<blocks, THREADS, 0, s>>>(
      (const int32_t*)best, (const int32_t*)mins, (int32_t*)pk, H, Wc, D, min_disp, Dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lr_keep_kernel<<<blocks, THREADS, 0, s>>>(
      (const int32_t*)pk, (const float*)disp, (uint8_t*)keep, H, Wc, x0,
      min_disp, Dq, max_diff);
  return (int)cudaGetLastError();
}

}  // extern "C"
