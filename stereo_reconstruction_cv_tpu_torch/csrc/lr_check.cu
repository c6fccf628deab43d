// Left-right consistency check (OpenCV disp12MaxDiff) from the WTA maps.
//
// Replaces the TPU kernel stereo_reconstruction_cv_tpu/ops/pallas/lr_pallas.py
// lr_check_maps_pallas (kernel _lr_kernel), which computes the right-view
// winner map as a gather over D rotated copies of the maps because a TPU has
// no fast scatter. On a GPU the scatter is the natural form, as in OpenCV,
// and like the TPU kernel it is row-local: a right-view row needs only its
// own left row. So one launch, one block per `rows` image rows, and the
// right-view winner rows (Wf = min_disp + D + Wc keys each) in shared memory:
//
//   1. fill the keys with NO_PARTNER;
//   2. every left pixel x (full-frame column x0 + xc) with 0 <= best < D
//      scatters its packed winner minS*Dq + best into right column
//      x - min_disp - best with a shared-memory atomicMin. Dq is the power of
//      two >= D + 1, so one min picks the smallest winning cost and, on ties,
//      the smallest d: the result is bit-identical to the gather form
//      whatever the order of the atomics. Every pixel scatters,
//      uniqueness-invalid ones included, as the reference does;
//   3. each left pixel checks the floor and the ceil of its subpixel
//      disparity; a check passes when the partner is off-image, has no
//      winner, or agrees within disp12MaxDiff. The pixel is kept if either
//      check passes (ANDed into the output where and_into is set).
//
// best and minS are read once (step 2), disp once (step 3), as 16-byte
// vectors where Wc % 4 == 0 and the maps are aligned; keep is written 4
// bytes at a time there. No global scratch, no memset, no global atomics.
//
// What bounds it on an H100: 13 bytes a pixel of (H, Wc) maps (4 + 4 + 4
// read, 1 written), 0.030 ms at 4K x 256 and 0.0032 ms at 720p x 128 at
// 3.35 TB/s. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/probe_sweep.py, CUDA-graph replay): 0.046 ms at 4K, 0.65 of that
// bound, and 0.005 ms at 720p, where one launch's latency is most of it.
// The first design (a memset of an (H, Wf) scratch, a scatter with one
// global atomicMin a pixel, a gather kernel) took 0.116 and 0.010 ms. The
// rows' keys take 15 KB at 4K, so eight blocks share an SM; a row longer
// than 12288 keys asks for more than 48 KB of dynamic shared memory
// (cudaFuncSetAttribute), and ops/cuda/lr.py refuses one beyond what a
// block can hold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Larger than any packed key (ops/cuda/lr.py bounds minS*Dq + best below it).
constexpr int32_t NO_PARTNER = 0x7f7f7f7f;
constexpr int THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

template <int V>
__device__ __forceinline__ void load_i32(const int32_t* p, int32_t (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ bool partner_agrees(const int32_t* pkrow, int x, int di, int Wf,
                                               int Dq, int min_disp, int max_diff) {
  const int xr = x - di;
  if (xr < 0 || xr >= Wf) return true;
  const int p = pkrow[xr];
  if (p == NO_PARTNER) return true;
  const int dR = (p & (Dq - 1)) + min_disp;
  return abs(dR - di) <= max_diff;
}

// V pixels a thread step (4: vector accesses, Wc % 4 == 0; 1: any Wc).
template <int V>
__global__ void __launch_bounds__(THREADS)
lr_check_kernel(const int32_t* __restrict__ best, const int32_t* __restrict__ mins,
                const float* __restrict__ disp, uint8_t* __restrict__ keep, int H, int Wc,
                int D, int min_disp, int Dq, int max_diff, int rows, int and_into) {
  extern __shared__ int4 smem[];
  int32_t* pk = reinterpret_cast<int32_t*>(smem);  // nr rows of Wf keys
  const int x0 = min_disp + D;
  const int Wf = x0 + Wc;
  const int y0 = blockIdx.x * rows;
  const int nr = min(rows, H - y0);
  const int nkeys = nr * Wf;
  const int4 fill = make_int4(NO_PARTNER, NO_PARTNER, NO_PARTNER, NO_PARTNER);
  for (int k = threadIdx.x; k < nkeys / 4; k += THREADS) smem[k] = fill;
  for (int k = nkeys / 4 * 4 + threadIdx.x; k < nkeys; k += THREADS) pk[k] = NO_PARTNER;
  __syncthreads();
  const size_t base = (size_t)y0 * Wc;
  const int n = nr * Wc;
  for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
    int32_t b[V], m[V];
    load_i32<V>(best + base + i, b);
    load_i32<V>(mins + base + i, m);
    const int r = i / Wc;
    int32_t* row = pk + r * Wf;
    const int xr = x0 + (i - r * Wc) - min_disp;  // right column of d = 0
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (b[j] >= 0 && b[j] < D) atomicMin(&row[xr + j - b[j]], m[j] * Dq + b[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
    float d[V];
    load_f32<V>(disp + base + i, d);
    const int r = i / Wc;
    const int32_t* row = pk + r * Wf;
    const int x = x0 + (i - r * Wc);
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int df = (int)floorf(d[j]);
      const int dc = (int)ceilf(d[j]);
      const bool k = partner_agrees(row, x + j, df, Wf, Dq, min_disp, max_diff) ||
                     partner_agrees(row, x + j, dc, Wf, Dq, min_disp, max_diff);
      bits |= (uint32_t)k << (8 * j);
    }
    uint8_t* out = keep + base + i;
    if constexpr (V == 4) {
      uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
      *out4 = and_into ? (*out4 & bits) : bits;
    } else {
      *out = and_into ? (*out & (uint8_t)bits) : (uint8_t)bits;
    }
  }
}

template <int V>
int launch(const void* best, const void* mins, const void* disp, void* keep, int H, int Wc,
           int D, int min_disp, int Dq, int max_diff, int rows, int and_into, size_t smem,
           cudaStream_t s) {
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        lr_check_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((H + rows - 1) / rows);
  lr_check_kernel<V><<<blocks, THREADS, smem, s>>>(
      (const int32_t*)best, (const int32_t*)mins, (const float*)disp, (uint8_t*)keep, H, Wc, D,
      min_disp, Dq, max_diff, rows, and_into);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) { return (uintptr_t)p % a == 0; }

}  // namespace

extern "C" {

// best, minS: (H, Wc) int32; disp: (H, Wc) f32; keep: (H, Wc) u8, written
// (and_into 0) or ANDed into (and_into 1); all contiguous. `rows` image rows
// a block, rows * (min_disp + D + Wc) keys of shared memory (the caller
// bounds it by what a block can hold).
int srcv_lr_check(const void* best, const void* mins, const void* disp, void* keep, int H,
                  int Wc, int D, int min_disp, int max_diff, int rows, int and_into,
                  void* stream) {
  if (H <= 0 || Wc <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int Dq = 1;
  while (Dq < D + 1) Dq *= 2;
  const size_t smem = sizeof(int32_t) * (size_t)rows * (min_disp + D + Wc);
  const bool vec = Wc % 4 == 0 && aligned(best, 16) && aligned(mins, 16) &&
                   aligned(disp, 16) && aligned(keep, 4);
  return vec ? launch<4>(best, mins, disp, keep, H, Wc, D, min_disp, Dq, max_diff, rows,
                         and_into, smem, s)
             : launch<1>(best, mins, disp, keep, H, Wc, D, min_disp, Dq, max_diff, rows,
                         and_into, smem, s);
}

}  // extern "C"
