// A chain of REPS = 96 dependent steps over each row of an (H, W) array:
//   r = roll(x, 1) along W   [if ROLL]      (out[i] = x[i - 1], wrapping)
//   r = r + one              [if ADD]
//   x = min(x, r)            [if MIN; else x = r]
// for float32, int32, int16, uint16 and bfloat16.
//
// Replaces the TPU kernel of tools/micro_i16.py (run -> _chain_kernel), the
// probe that asks whether 16-bit add / min / roll chains run faster than
// 32-bit ones, which on the card decides how the SGM sweeps should hold their
// carries.
//
// What bounds it on an H100: operations. Each element is read and written
// once (2 or 4 bytes each way) and takes REPS * (ADD + MIN) dependent
// operations; a row's elements are independent of each other, so E of them
// per lane give the scheduler E independent chains to interleave. The REPS
// steps are written out, as the reference's chain is.
//
// Design: one warp per row, E = W / 32 consecutive elements per lane, in
// registers. The roll shifts each lane's registers up by one and takes the
// first from the lane below (lane 0 from lane 31: the roll wraps around the
// row, as pltpu.roll and torch.roll do) with one __shfl_sync. Every element
// sits in its own 32-bit register, 16-bit ones included: this simple kernel
// does not pack two 16-bit values per register (__vminu2, __hmin2).
//
// Folding: with ops = (add, min) and one = 1 the chain is the identity,
// x = min(x, x + 1). So that the compiler cannot fold it away, `one` is a
// kernel argument and integer additions wrap (unsigned arithmetic, as the
// reference's integer adds do), so min(x, x + one) is not x + min(0, one);
// bfloat16 goes through __hadd / __hmin and float32 through __fadd_rn.
// chip_smoke.py counts the min instructions of these kernels in the SASS.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // rows per block
constexpr int REPS = 96;  // the reference's unrolled chain length
constexpr int ROLL = 1, ADD = 2, MIN = 4;  // bits of `ops`

__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int32_t add_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t min_(int32_t a, int32_t b) { return min(a, b); }
__device__ __forceinline__ int16_t add_(int16_t a, int16_t b) {
  return (int16_t)(uint16_t)((uint32_t)(uint16_t)a + (uint32_t)(uint16_t)b);
}
__device__ __forceinline__ int16_t min_(int16_t a, int16_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint16_t add_(uint16_t a, uint16_t b) {
  return (uint16_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ uint16_t min_(uint16_t a, uint16_t b) { return a < b ? a : b; }
__device__ __forceinline__ __nv_bfloat16 add_(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hadd(a, b);
}
__device__ __forceinline__ __nv_bfloat16 min_(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmin(a, b);
}

// __shfl_sync of any type of at most 4 bytes, through its bits.
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  uint32_t u = 0;
  memcpy(&u, &v, sizeof(T));
  u = __shfl_sync(FULL, u, src);
  T r;
  memcpy(&r, &u, sizeof(T));
  return r;
}

// One step of the chain over the lane's E elements.
template <typename T, int E, int OPS>
__device__ __forceinline__ void step(T (&x)[E], T one, int below) {
  T r[E];
  if constexpr ((OPS & ROLL) != 0) {
    r[0] = shfl(x[E - 1], below);
#pragma unroll
    for (int e = 1; e < E; ++e) r[e] = x[e - 1];
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = x[e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr ((OPS & ADD) != 0) r[e] = add_(r[e], one);
    if constexpr ((OPS & MIN) != 0) {
      x[e] = min_(x[e], r[e]);
    } else {
      x[e] = r[e];
    }
  }
}

template <typename T, int E, int OPS>
__global__ void __launch_bounds__(32 * WARPS)
op_chain_kernel(const T* __restrict__ in, T* __restrict__ out, int H, T one) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= H) return;  // whole warps only
  const size_t base = (size_t)row * (32 * E) + lane * E;
  const int below = (lane + 31) & 31;
  T x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = in[base + e];
#pragma unroll
  for (int i = 0; i < REPS; ++i) step<T, E, OPS>(x, one, below);
#pragma unroll
  for (int e = 0; e < E; ++e) out[base + e] = x[e];
}

template <typename T, int E, int OPS>
int launch(const void* in, void* out, int H, T one, cudaStream_t stream) {
  const int blocks = (H + WARPS - 1) / WARPS;
  op_chain_kernel<T, E, OPS><<<blocks, 32 * WARPS, 0, stream>>>((const T*)in, (T*)out, H, one);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_ops(const void* in, void* out, int H, int ops, T one, cudaStream_t s) {
  switch (ops) {
    case 0: return launch<T, E, 0>(in, out, H, one, s);
    case 1: return launch<T, E, 1>(in, out, H, one, s);
    case 2: return launch<T, E, 2>(in, out, H, one, s);
    case 3: return launch<T, E, 3>(in, out, H, one, s);
    case 4: return launch<T, E, 4>(in, out, H, one, s);
    case 5: return launch<T, E, 5>(in, out, H, one, s);
    case 6: return launch<T, E, 6>(in, out, H, one, s);
    case 7: return launch<T, E, 7>(in, out, H, one, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_w(const void* in, void* out, int H, int W, int ops, T one, cudaStream_t s) {
  switch (W) {
    case 32: return launch_ops<T, 1>(in, out, H, ops, one, s);
    case 64: return launch_ops<T, 2>(in, out, H, ops, one, s);
    case 128: return launch_ops<T, 4>(in, out, H, ops, one, s);
    case 256: return launch_ops<T, 8>(in, out, H, ops, one, s);
    case 512: return launch_ops<T, 16>(in, out, H, ops, one, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in, out: (H, W) arrays of dtype 0 float32, 1 int32, 2 int16, 3 uint16,
// 4 bfloat16; W in {32, 64, 128, 256, 512}; ops: bits 1 roll, 2 add, 4 min.
int srcv_op_chain(const void* in, void* out, int H, int W, int dtype, int ops,
                  void* stream) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_w<float>(in, out, H, W, ops, 1.0f, s);
    case 1: return launch_w<int32_t>(in, out, H, W, ops, 1, s);
    case 2: return launch_w<int16_t>(in, out, H, W, ops, (int16_t)1, s);
    case 3: return launch_w<uint16_t>(in, out, H, W, ops, (uint16_t)1, s);
    case 4: return launch_w<__nv_bfloat16>(in, out, H, W, ops, __float2bfloat16(1.0f), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
