// The points layer: an (H, W) float32 disparity map reprojected to (H, W, 3)
// float32 points (one launch a frame), and one pair's points compacted into
// its cloud in row-major order (one call a frame, two launches).
//
// Replaces no TPU kernel. The JAX package reprojects with XLA elementwise
// ops (ops/geometry.py:reproject_image_to_3d) and writes the cloud on the
// host. The kernels replace the chains of PyTorch ops of
// ops/cuda/cloud.py:reproject_plain (two aranges, the sixteen products and
// sums, a where, three divisions and a stack: ~25 full-frame kernels) and
// :compact_plain (isfinite, all, the masks, an int64 cumsum, where,
// index_copy_ and sum: ~12), each intermediate a frame in device memory.
//
// Q's sixteen values travel by value, as launch arguments: nothing is copied
// to the card for them, so the host never waits on the stream here.
//
// What bounds them on an H100: bytes.
//   - Reprojection: reads 4 B of disparity and writes 12 B of points a
//     pixel: 0.0396 ms a 4K frame at 3.35 TB/s. A block takes RPX
//     consecutive pixels of the flat frame, a thread four of them (one
//     16-byte load), and the block's points leave through shared memory in
//     coalesced 16-byte stores (reproject_kernel).
//   - Compaction: reads the disparity (4 B), the valid mask (1 B) and the
//     points of the pixels whose mask and disparity pass (12 B), and writes
//     the kept points (12 B). Tiles of TILE pixels. Pass 1 (count_kernel)
//     tests each pixel and writes one ballot word a warp and 32 pixels
//     (1/8 B a pixel) and the tile's count. Pass 2 (scatter_kernel) sums
//     the counts of the tiles before its own (at most a few thousand ints,
//     from L2), scans its words' popcounts and copies each kept pixel's
//     point to its rank: it reads the kept points a second time, so the
//     pass moves ~12 B a kept pixel above the bound. Row-major order is
//     kept exactly, and nothing depends on the order blocks run in: the
//     result is deterministic. The last tile writes the count; no buffer
//     needs clearing first.
//
// Numerics: bit-equal to reproject_plain. Each product and sum is rounded on
// its own, in the plain version's order ((x q0 + y q1) + d q2) + q3; the
// intrinsics keep nvcc from contracting them into FMAs. W == 0 maps to
// +inf, as torch.where does, and the quotients are __fdiv_rn. x and y are
// the pixel's column and row as floats, exact below 2^24.
// A point is kept where valid, disparity > 0 (NaN fails) and all three
// coordinates are finite, as compact_plain's mask.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Q16 {
  float q[16];  // row-major 4 x 4
};

constexpr int RT = 256;      // reprojection threads a block
constexpr int RPX = 4 * RT;  // pixels a block

__device__ __forceinline__ float row_dot(const Q16& Q, int i, float x, float y, float d) {
  float s = __fadd_rn(__fmul_rn(x, Q.q[4 * i]), __fmul_rn(y, Q.q[4 * i + 1]));
  s = __fadd_rn(s, __fmul_rn(d, Q.q[4 * i + 2]));
  return __fadd_rn(s, Q.q[4 * i + 3]);
}

// Pixel (x, y) of disparity d -> (X, Y, Z) = (o0, o1, o2) / (o3, or inf where 0).
__device__ __forceinline__ void point(const Q16& Q, float x, float y, float d, float* p) {
  const float o3 = row_dot(Q, 3, x, y, d);
  const float w = o3 == 0.f ? __int_as_float(0x7f800000) : o3;
  p[0] = __fdiv_rn(row_dot(Q, 0, x, y, d), w);
  p[1] = __fdiv_rn(row_dot(Q, 1, x, y, d), w);
  p[2] = __fdiv_rn(row_dot(Q, 2, x, y, d), w);
}

// VEC: a whole block of RPX pixels, both pointers 16-byte aligned. Each
// thread computes 4 consecutive pixels from one float4 of disparity; the
// block's 12 KB of points are staged in shared memory so that each warp
// stores 512 contiguous bytes an instruction (3 float4 a thread at a 48-byte
// stride would leave every store's sectors half written). Otherwise (the
// frame's last block, unaligned pointers) one pixel a thread at a time.
template <bool VEC>
__global__ void __launch_bounds__(RT)
reproject_kernel(const float* __restrict__ disp, float* __restrict__ out, int W, int n,
                 const Q16 Q) {
  const int base = blockIdx.x * RPX;
  if (VEC && base + RPX <= n) {  // uniform over the block
    __shared__ float4 stage[3 * RT];
    const int p0 = base + 4 * threadIdx.x;
    int y = p0 / W, x = p0 - y * W;
    const float4 d = __ldg(reinterpret_cast<const float4*>(disp + p0));
    const float ds[4] = {d.x, d.y, d.z, d.w};
    float v[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      point(Q, (float)x, (float)y, ds[j], v + 3 * j);
      if (++x == W) x = 0, ++y;
    }
    stage[3 * threadIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
    stage[3 * threadIdx.x + 1] = make_float4(v[4], v[5], v[6], v[7]);
    stage[3 * threadIdx.x + 2] = make_float4(v[8], v[9], v[10], v[11]);
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + 3 * (size_t)base);
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k * RT + threadIdx.x] = stage[k * RT + threadIdx.x];
  } else {
    const int end = min(n, base + RPX);
    for (int p = base + threadIdx.x; p < end; p += RT) {
      const int y = p / W, x = p - y * W;
      point(Q, (float)x, (float)y, __ldg(disp + p), out + 3 * (size_t)p);
    }
  }
}

constexpr int CT = 256;            // compaction threads a block
constexpr int ITEMS = 16;          // pixels a thread
constexpr int TILE = CT * ITEMS;   // pixels a tile: ops/cuda/cloud.py TILE
constexpr int WORDS = TILE / 32;   // ballot words a tile
constexpr int WARPS = CT / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(WORDS <= CT && WORDS % 32 == 0, "one thread a word in the scan");

__device__ __forceinline__ bool kept(const float* __restrict__ disp,
                                     const uint8_t* __restrict__ valid,
                                     const float* __restrict__ pts, int p) {
  if (!(valid[p] & (disp[p] > 0.f))) return false;  // both loads issued at once
  const float* q = pts + 3 * (size_t)p;
  return isfinite(q[0]) && isfinite(q[1]) && isfinite(q[2]);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Pass 1: word k of tile t holds pixels t * TILE + 32 k + (0..31), bit =
// lane; counts[t] the tile's kept pixels.
__global__ void __launch_bounds__(CT)
count_kernel(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
             const float* __restrict__ pts, int n, uint32_t* __restrict__ words,
             int* __restrict__ counts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int base = blockIdx.x * TILE;
  int c = 0;
#pragma unroll 4
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * CT + threadIdx.x;
    const bool k = base + j < n && kept(disp, valid, pts, base + j);
    const uint32_t b = __ballot_sync(FULL, k);
    if (lane == 0) words[(size_t)blockIdx.x * WORDS + j / 32] = b;
    c += __popc(b);
  }
  __shared__ int wc[WARPS];
  if (lane == 0) wc[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += wc[w];
    counts[blockIdx.x] = s;
  }
}

// Pass 2: tile t's kept pixels go to rows (sum of counts[0..t)) + their rank
// in the tile; the last tile writes the total to *count.
__global__ void __launch_bounds__(CT)
scatter_kernel(const float* __restrict__ pts, int ntiles,
               const uint32_t* __restrict__ words, const int* __restrict__ counts,
               float* __restrict__ out, long long* __restrict__ count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  __shared__ uint32_t bits[WORDS];
  __shared__ int rank0[WORDS];  // kept pixels of the tile before word k
  __shared__ int before[WARPS], wtot[WORDS / 32];

  int s = 0;  // the tiles before this one
  for (int t = threadIdx.x; t < tile; t += CT) s += __ldg(counts + t);
  s = warp_sum(s);
  if (lane == 0) before[warp] = s;

  uint32_t b = 0;
  int v = 0;
  if (threadIdx.x < WORDS) {
    b = __ldg(words + (size_t)tile * WORDS + threadIdx.x);
    v = __popc(b);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive scan within the warp
      const int u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wtot[warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < WORDS) {
    int add = 0;
    for (int w = 0; w < warp; ++w) add += wtot[w];
    bits[threadIdx.x] = b;
    rank0[threadIdx.x] = add + v - __popc(b);
  }
  int offset = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) offset += before[w];
  __syncthreads();

  const int base = tile * TILE;
#pragma unroll 4
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * CT + threadIdx.x;
    const uint32_t w = bits[j / 32];
    if ((w >> lane) & 1u) {
      const size_t dst = 3 * (size_t)(offset + rank0[j / 32] + __popc(w & ((1u << lane) - 1u)));
      const float* src = pts + 3 * (size_t)(base + j);
      out[dst] = src[0];
      out[dst + 1] = src[1];
      out[dst + 2] = src[2];
    }
  }
  if (tile == ntiles - 1 && threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WORDS / 32; ++w) total += wtot[w];
    *count = (long long)offset + total;
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Pixel indices, tile ends and thread offsets stay below 2^31.
constexpr long long MAX_PIXELS = 0x7fffffffLL - TILE;

}  // namespace

extern "C" {

// disp: (H, W) float32; out: (H, W, 3) float32; both contiguous. q0..q15:
// Q row-major. Returns cudaGetLastError() after the launch.
int srcv_cloud_reproject(const void* disp, void* out, int H, int W, float q0, float q1,
                         float q2, float q3, float q4, float q5, float q6, float q7, float q8,
                         float q9, float q10, float q11, float q12, float q13, float q14,
                         float q15, void* stream) {
  const long long n = (long long)H * W;
  if (n <= 0) return 0;
  if (n > MAX_PIXELS) return (int)cudaErrorInvalidValue;
  const Q16 Q = {{q0, q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15}};
  const unsigned blocks = (unsigned)((n + RPX - 1) / RPX);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(disp) && aligned16(out)) {
    reproject_kernel<true><<<blocks, RT, 0, s>>>((const float*)disp, (float*)out, W, (int)n, Q);
  } else {
    reproject_kernel<false><<<blocks, RT, 0, s>>>((const float*)disp, (float*)out, W, (int)n, Q);
  }
  return (int)cudaGetLastError();
}

// disp: (n,) float32; valid: (n,) bool; pts: (n, 3) float32; out: (n, 3)
// float32, its first *count rows the kept points in row-major order;
// count: one int64; scratch: scratch_ints int32 of work space, at least
// ceil(max(n, 1) / TILE) * (WORDS + 1). All contiguous. Returns
// cudaGetLastError() after the two launches.
int srcv_cloud_compact(const void* disp, const void* valid, const void* pts, void* out,
                       void* count, void* scratch, int n, int scratch_ints, void* stream) {
  if (n < 0 || n > MAX_PIXELS) return (int)cudaErrorInvalidValue;
  const int ntiles = n == 0 ? 1 : (int)(((long long)n + TILE - 1) / TILE);
  if ((long long)ntiles * (WORDS + 1) > scratch_ints) return (int)cudaErrorInvalidValue;
  uint32_t* words = (uint32_t*)scratch;
  int* counts = (int*)scratch + (size_t)ntiles * WORDS;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<ntiles, CT, 0, s>>>((const float*)disp, (const uint8_t*)valid,
                                     (const float*)pts, n, words, counts);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  scatter_kernel<<<ntiles, CT, 0, s>>>((const float*)pts, ntiles, words, counts,
                                       (float*)out, (long long*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
