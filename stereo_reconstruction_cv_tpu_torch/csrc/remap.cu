// Four-tap bilinear remap (cv2.remap INTER_LINEAR, BORDER_CONSTANT = 0) of
// an (H, W) or (H, W, C) image through an (Ho, Wo, 2) float32 map of source
// (x, y): the rectify layer's one launch a frame.
//
// Replaces no TPU kernel. The JAX package remaps with XLA gathers, and its
// banded-matmul and packed one-gather paths were TPU gather workarounds
// that are not ported. The kernel replaces the chain of PyTorch ops of
// ops/cuda/remap.py:remap_bilinear_plain (floor, casts, masks, clamps, four
// gathers, four wheres, the weights and the sum: ~70 full-frame kernels,
// each intermediate a float32 or int64 frame in device memory).
//
// What bounds it on an H100: bytes. A pixel reads 8 B of map, ~1 B of
// source (neighbouring pixels share their taps) and writes 1 B: 10 B a
// uint8 pixel, 0.050 ms a 4K pair and 0.0055 ms a 720p pair at 3.35 TB/s.
// The map is 80% of them, so:
//   - each thread writes V = 4 consecutive pixels of a row: two 16-byte
//     map loads and one 4-byte store (uint8) where Wo % 4 == 0 and the
//     pointers are aligned, one pixel at a time (V = 1) otherwise;
//   - blocks are 128 px x 8 row tiles. Rectification maps are smooth, so a
//     tile's taps fall in a small source window, read through the
//     read-only path (__ldg): neighbouring taps hit L1 / L2.
//
// Numerics: bit-equal to remap_bilinear_plain. Each product and sum is
// rounded on its own, as the separate torch kernels round them, in the
// plain version's order ((t00 w00 + t10 w10) + t01 w01) + t11 w11; the
// intrinsics keep nvcc from contracting them into FMAs. A tap outside
// [0, W) x [0, H) reads 0; its bounds test never converts a float that an
// int cannot hold, so no finite map value wraps an index. uint8 output is
// rintf (round half to even, as torch.round), float32 output the sum.
// Non-finite map values are out of scope.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8;  // threads a block; a tile is TX * V px x TY rows

// floorf of a map coordinate as an int, or -2 where it lies outside
// (-2, 2^31): both taps (v0 and v0 + 1) are then off any image, as -2's are.
__device__ __forceinline__ int base_index(float v0) {
  return (v0 > -2.f && v0 < 2147483648.f) ? (int)v0 : -2;
}

template <typename T>
__device__ __forceinline__ float tap(const T* __restrict__ src, bool inside, size_t off) {
  return inside ? (float)__ldg(src + off) : 0.f;
}

template <typename T>
__device__ __forceinline__ T to_out(float acc) {
  if constexpr (sizeof(T) == 1) {
    return (T)rintf(acc);
  } else {
    return acc;
  }
}

// One output pixel's C channels from source coordinate (x, y).
template <typename T, int C>
__device__ __forceinline__ void sample(const T* __restrict__ src, int H, int W, float x,
                                       float y, T (&out)[C]) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx, gy), w10 = __fmul_rn(fx, gy);
  const float w01 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  const int xb = base_index(x0), yb = base_index(y0);
  const bool inx0 = xb >= 0 && xb < W, inx1 = xb >= -1 && xb < W - 1;
  const bool iny0 = yb >= 0 && yb < H, iny1 = yb >= -1 && yb < H - 1;
  const size_t row0 = (size_t)yb * W, row1 = row0 + W;  // used only where inside
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float t00 = tap(src, inx0 && iny0, (row0 + xb) * C + c);
    const float t10 = tap(src, inx1 && iny0, (row0 + xb + 1) * C + c);
    const float t01 = tap(src, inx0 && iny1, (row1 + xb) * C + c);
    const float t11 = tap(src, inx1 && iny1, (row1 + xb + 1) * C + c);
    float acc = __fadd_rn(__fmul_rn(t00, w00), __fmul_rn(t10, w10));
    acc = __fadd_rn(acc, __fmul_rn(t01, w01));
    acc = __fadd_rn(acc, __fmul_rn(t11, w11));
    out[c] = to_out<T>(acc);
  }
}

// V = 4: Wo % 4 == 0, map 16-byte aligned, out aligned for one store of
// four pixels (C == 1) -- vector loads and stores. V = 1: any shape.
template <typename T, int C, int V>
__global__ void __launch_bounds__(TX * TY)
remap_kernel(const T* __restrict__ src, const float* __restrict__ map, T* __restrict__ out,
             int H, int W, int Ho, int Wo) {
  const int oy = blockIdx.y * TY + threadIdx.y;
  const int ox = (blockIdx.x * TX + threadIdx.x) * 4;
  if (oy >= Ho || ox >= Wo) return;
  const size_t p = (size_t)oy * Wo + ox;
  if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(map + 2 * p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(map + 2 * p) + 1);
    T v[4][C];
    sample<T, C>(src, H, W, a.x, a.y, v[0]);
    sample<T, C>(src, H, W, a.z, a.w, v[1]);
    sample<T, C>(src, H, W, b.x, b.y, v[2]);
    sample<T, C>(src, H, W, b.z, b.w, v[3]);
    if constexpr (C == 1 && sizeof(T) == 1) {
      *reinterpret_cast<uchar4*>(out + p) = make_uchar4(v[0][0], v[1][0], v[2][0], v[3][0]);
    } else if constexpr (C == 1) {
      *reinterpret_cast<float4*>(out + p) = make_float4(v[0][0], v[1][0], v[2][0], v[3][0]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) out[(p + j) * C + c] = v[j][c];
    }
  } else {
    const int n = min(4, Wo - ox);  // the row's tail
    for (int j = 0; j < n; ++j) {
      T v[C];
      sample<T, C>(src, H, W, __ldg(map + 2 * (p + j)), __ldg(map + 2 * (p + j) + 1), v);
#pragma unroll
      for (int c = 0; c < C; ++c) out[(p + j) * C + c] = v[c];
    }
  }
}

bool aligned(const void* p, uintptr_t a) { return (uintptr_t)p % a == 0; }

template <typename T, int C>
int launch(const void* src, const void* map, void* out, int H, int W, int Ho, int Wo,
           cudaStream_t s) {
  const dim3 block(TX, TY);
  const dim3 grid((unsigned)((Wo + 4 * TX - 1) / (4 * TX)), (unsigned)((Ho + TY - 1) / TY));
  const bool vec = Wo % 4 == 0 && aligned(map, 16) && (C != 1 || aligned(out, 4 * sizeof(T)));
  if (vec) {
    remap_kernel<T, C, 4><<<grid, block, 0, s>>>((const T*)src, (const float*)map, (T*)out, H,
                                                   W, Ho, Wo);
  } else {
    remap_kernel<T, C, 1><<<grid, block, 0, s>>>((const T*)src, (const float*)map, (T*)out, H,
                                                   W, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (H, W, C) uint8 (is_float 0) or float32 (is_float 1), C 1 or 3; map:
// (Ho, Wo, 2) float32 source (x, y); out: (Ho, Wo, C) of src's type; all
// contiguous. Returns cudaGetLastError() after the launch.
int srcv_remap_bilinear(const void* src, const void* map, void* out, int H, int W, int Ho,
                        int Wo, int channels, int is_float, void* stream) {
  if (Ho <= 0 || Wo <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 1) {
    return is_float ? launch<float, 1>(src, map, out, H, W, Ho, Wo, s)
                    : launch<uint8_t, 1>(src, map, out, H, W, Ho, Wo, s);
  }
  if (channels == 3) {
    return is_float ? launch<float, 3>(src, map, out, H, W, Ho, Wo, s)
                    : launch<uint8_t, 3>(src, map, out, H, W, Ho, Wo, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
