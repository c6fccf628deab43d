// Fused Birchfield-Tomasi cost + box aggregation over the cropped columns.
//
// Replaces the TPU kernel stereo_reconstruction_cv_tpu/ops/pallas/cost_pallas.py
// cost_volume_pallas (kernel _producer_kernel): out[y, xc, d] equals
// block_sum(bt_cost_volume(sl, sr, rl, rr, D, min_disp)[:, x0:, :], block)
// from ops/disparity.py, as int16, with x0 = min_disp + D.
//
// What bounds it on an H100: the int16 output write (2 B per cell, 4 GB at
// 3840x2160x256) against ~40 integer operations per cell for the two BT
// planes and the box. The planes themselves are small and stay in L1/L2.
//
// Design: one block owns TX cropped columns x TD disparities and walks all
// rows in a loop (the loop replaces the TPU's sequential grid axis). Per row,
// the block computes the pixel costs of its columns plus the box window's
// halo once into shared memory, each thread then sums its horizontal window
// from there, and a per-thread ring of `block` row sums keeps the vertical
// running sum. The window replicates at the crop origin x0 and at the right,
// top and bottom edges (block_sum on the cropped volume), and the right
// pixel x - (min_disp + d) is clamped at the image's left edge. Everything is
// integer; the caller bounds block^2 * (2*cap + 63) <= 32767 so the int16
// store cannot wrap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TD = 32;  // disparities per block (threadIdx.x: coalesced d)
constexpr int TX = 16;  // cropped output columns per block (threadIdx.y)

// Value, half-pixel low and high of plane row `row` at column x, with the
// neighbours clamped at the plane edge (_halfpixel_range; values >= 0 so
// floor division is a shift).
__device__ __forceinline__ void half_range(const int32_t* row, int x, int W,
                                           int& v, int& lo, int& hi) {
  v = row[x];
  const int a = (v + row[max(x - 1, 0)]) >> 1;
  const int b = (v + row[min(x + 1, W - 1)]) >> 1;
  lo = min(min(a, b), v);
  hi = max(max(a, b), v);
}

// Symmetric BT cost of one plane between left column xl and right column xr.
__device__ __forceinline__ int bt_cost(const int32_t* lrow, const int32_t* rrow,
                                       int xl, int xr, int W) {
  int lv, llo, lhi, rv, rlo, rhi;
  half_range(lrow, xl, W, lv, llo, lhi);
  half_range(rrow, xr, W, rv, rlo, rhi);
  const int c0 = max(max(lv - rhi, rlo - lv), 0);
  const int c1 = max(max(rv - lhi, llo - rv), 0);
  return min(c0, c1);
}

__global__ void cost_volume_kernel(const int32_t* __restrict__ sl,
                                   const int32_t* __restrict__ sr,
                                   const int32_t* __restrict__ rl,
                                   const int32_t* __restrict__ rr,
                                   int16_t* __restrict__ out, int H, int W,
                                   int D, int min_disp, int block) {
  extern __shared__ int smem[];
  const int lo = -(block / 2);       // window taps [lo, hi] around a column/row
  const int hi = block - 1 + lo;
  const int ncols = TX + block - 1;  // strip columns plus window halo
  const int nthreads = TX * TD;
  const int tid = threadIdx.y * TD + threadIdx.x;
  int* pix = smem;                   // [ncols][TD] pixel costs of one row
  int* ring = smem + ncols * TD;     // [block][nthreads] horizontal sums

  const int x0 = min_disp + D;
  const int Wc = W - x0;
  const int xc_base = blockIdx.x * TX;
  const int xc = xc_base + threadIdx.y;
  const int d = blockIdx.y * TD + threadIdx.x;

  for (int k = 0; k < block; ++k) ring[k * nthreads + tid] = 0;
  int vsum = 0;
  int slot = 0;
  for (int j = lo; j <= H - 1 + hi; ++j) {
    const int y = min(max(j, 0), H - 1);
    const int32_t* slr = sl + (size_t)y * W;
    const int32_t* srr = sr + (size_t)y * W;
    const int32_t* rlr = rl + (size_t)y * W;
    const int32_t* rrr = rr + (size_t)y * W;
    // tid % TD == threadIdx.x and the stride is a multiple of TD, so every
    // entry this thread fills has the thread's own disparity.
    for (int i = tid; i < ncols * TD; i += nthreads) {
      int c = 0;
      if (d < D) {
        const int xcc = min(max(xc_base + lo + i / TD, 0), Wc - 1);
        const int xl = x0 + xcc;
        const int xr = max(xl - (min_disp + d), 0);
        c = bt_cost(slr, srr, xl, xr, W) + (bt_cost(rlr, rrr, xl, xr, W) >> 2);
      }
      pix[i] = c;
    }
    __syncthreads();
    int h = 0;
    for (int k = 0; k < block; ++k) h += pix[(threadIdx.y + k) * TD + threadIdx.x];
    int* r = ring + slot * nthreads + tid;
    vsum += h - *r;
    *r = h;
    slot = (slot + 1 == block) ? 0 : slot + 1;
    const int yo = j - hi;  // the window of output row yo is now complete
    if (yo >= 0 && xc < Wc && d < D) {
      out[((size_t)yo * Wc + xc) * D + d] = (int16_t)vsum;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Planes: four (H, W) int32, contiguous, border-pinned by the caller.
// out: (H, W - min_disp - D, D) int16, contiguous.
int srcv_cost_volume(const void* sl, const void* sr, const void* rl,
                     const void* rr, void* out, int H, int W, int D,
                     int min_disp, int block, void* stream) {
  const int Wc = W - (min_disp + D);
  const size_t smem = sizeof(int) * ((size_t)(TX + block - 1) * TD + (size_t)block * TX * TD);
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wc + TX - 1) / TX, (D + TD - 1) / TD);
  dim3 threads(TD, TX);
  cost_volume_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sl, (const int32_t*)sr, (const int32_t*)rl,
      (const int32_t*)rr, (int16_t*)out, H, W, D, min_disp, block);
  return (int)cudaGetLastError();
}

const char* srcv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
