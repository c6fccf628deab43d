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
// registers. 32-bit types hold one element a register: the roll shifts the
// lane's registers up by one (renaming, no instruction) and takes the first
// from the lane below (lane 0 from lane 31: the roll wraps around the row, as
// pltpu.roll and torch.roll do) with one __shfl_sync. int32 add + min is one
// DPX __viaddmin_s32; float32 has no fused form (__fadd_rn, fminf).
//
// 16-bit types hold two elements a 32-bit register, so each instruction
// works on a pair. Register j of a lane pairs its elements j (low half) and
// j + E/2 (high half), not two neighbours: then the roll moves register j - 1
// whole into register j (renaming again), and only register 0 is built,
// from the high half of the lane below's last register (one __shfl_sync)
// and the low half of this lane's last register (one __byte_perm). Two
// neighbours to a register would take one __byte_perm per register. add +
// min is one DPX __viaddmin_s16x2 / __viaddmin_u16x2 per register, add alone
// __vadd2, min alone __vmins2 / __vminu2; bfloat16 pairs go through __hadd2
// and __hmin2 on __nv_bfloat162. At W = 32 a lane holds one element, which
// keeps a register of its own (scalar 16-bit operations).
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): a 16-bit add+min
// step is 8 VIADDMNMX.S16x2 (.U16x2) against int32's 16 VIADDMNMX, yet
// takes 0.77-0.82 of int32's time at (16384, 512): the packed DPX
// instruction costs about 1.6x the 32-bit one. ptxas issues half of the
// bfloat16 __hadd2 as HFMA2.MMA, 10-12% slower than scalar __hadd, which
// it pairs into HADD2 itself.
//
// Semantics are the reference's: integer adds wrap (two's complement, no
// saturation). The CUDA documentation does not say whether the DPX adds
// wrap; the wrap-edge inputs (tools/micro_i16.py edge_values: each integer
// type's largest values) hold every dtype, op set and width to the plain
// version on the card (chip_smoke.py, tests/test_torch_gpu.py), and they
// wrap.
//
// Folding: with ops = (add, min) and one = 1 the chain is the identity,
// x = min(x, x + 1). So that the compiler cannot fold it away, `one` is a
// kernel argument and integer additions wrap, so min(x, x + one) is not
// x + min(0, one). chip_smoke.py counts the min instructions of these
// kernels in the SASS.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // rows per block
constexpr int REPS = 96;  // the reference's unrolled chain length
constexpr int ROLL = 1, ADD = 2, MIN = 4;  // bits of `ops`

// One element a register.
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float add_min_(float r, float one, float x) {
  return fminf(x, __fadd_rn(r, one));
}
__device__ __forceinline__ int32_t add_(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t min_(int32_t a, int32_t b) { return min(a, b); }
__device__ __forceinline__ int32_t add_min_(int32_t r, int32_t one, int32_t x) {
  return __viaddmin_s32(r, one, x);
}
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
template <typename T>
__device__ __forceinline__ T add_min_(T r, T one, T x) {
  return min_(x, add_(r, one));
}

// Two 16-bit elements a register: add, min and add + min of pairs.
template <typename T>
struct Pair;
template <>
struct Pair<int16_t> {
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) { return __vadd2(a, b); }
  static __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  static __device__ __forceinline__ uint32_t add_min(uint32_t r, uint32_t one, uint32_t x) {
    return __viaddmin_s16x2(r, one, x);
  }
};
template <>
struct Pair<uint16_t> {
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) { return __vadd2(a, b); }
  static __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  static __device__ __forceinline__ uint32_t add_min(uint32_t r, uint32_t one, uint32_t x) {
    return __viaddmin_u16x2(r, one, x);
  }
};
template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat162 h(uint32_t a) {
    __nv_bfloat162 v;
    memcpy(&v, &a, 4);
    return v;
  }
  static __device__ __forceinline__ uint32_t u(__nv_bfloat162 v) {
    uint32_t a;
    memcpy(&a, &v, 4);
    return a;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return u(__hadd2(h(a), h(b)));
  }
  static __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) {
    return u(__hmin2(h(a), h(b)));
  }
  static __device__ __forceinline__ uint32_t add_min(uint32_t r, uint32_t one, uint32_t x) {
    return u(__hmin2(h(x), __hadd2(h(r), h(one))));
  }
};

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

// One step of the chain over the lane's E elements, one a register.
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
    if constexpr ((OPS & ADD) != 0 && (OPS & MIN) != 0) {
      x[e] = add_min_(r[e], one, x[e]);
    } else if constexpr ((OPS & ADD) != 0) {
      x[e] = add_(r[e], one);
    } else if constexpr ((OPS & MIN) != 0) {
      x[e] = min_(x[e], r[e]);
    } else {
      x[e] = r[e];
    }
  }
}

// One step over the lane's R = E/2 registers of pairs (elements j, j + R).
template <typename T, int R, int OPS>
__device__ __forceinline__ void pair_step(uint32_t (&w)[R], uint32_t one, int below) {
  uint32_t r[R];
  if constexpr ((OPS & ROLL) != 0) {
    // Register 0 of the rolled lane: (the lane below's element E - 1, this
    // lane's element R - 1), the high halves of their last registers.
    r[0] = __byte_perm(__shfl_sync(FULL, w[R - 1], below), w[R - 1], 0x5432);
#pragma unroll
    for (int j = 1; j < R; ++j) r[j] = w[j - 1];
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) r[j] = w[j];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if constexpr ((OPS & ADD) != 0 && (OPS & MIN) != 0) {
      w[j] = Pair<T>::add_min(r[j], one, w[j]);
    } else if constexpr ((OPS & ADD) != 0) {
      w[j] = Pair<T>::add(r[j], one);
    } else if constexpr ((OPS & MIN) != 0) {
      w[j] = Pair<T>::min(w[j], r[j]);
    } else {
      w[j] = r[j];
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
  if constexpr (sizeof(T) == 2 && E >= 2) {
    constexpr int R = E / 2;
    const uint16_t* p = reinterpret_cast<const uint16_t*>(in) + base;
    uint16_t one16;
    memcpy(&one16, &one, 2);
    const uint32_t one2 = 0x10001u * one16;
    uint32_t w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) w[j] = (uint32_t)p[j] | ((uint32_t)p[j + R] << 16);
#pragma unroll
    for (int i = 0; i < REPS; ++i) pair_step<T, R, OPS>(w, one2, below);
    uint16_t* q = reinterpret_cast<uint16_t*>(out) + base;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      q[j] = (uint16_t)w[j];
      q[j + R] = (uint16_t)(w[j] >> 16);
    }
  } else {
    T x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = in[base + e];
#pragma unroll
    for (int i = 0; i < REPS; ++i) step<T, E, OPS>(x, one, below);
#pragma unroll
    for (int e = 0; e < E; ++e) out[base + e] = x[e];
  }
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
