// Speckle filter: connected-component labels, then the component-size test.
//
// Replaces the TPU flood kernels of
// stereo_reconstruction_cv_tpu/ops/pallas/speckle_pallas.py
// (flood_round_flagged, flood_round_pallas; kernel body _flood_kernel) and the
// scatter-free size test of ops/disparity.py:_component_keep_sort.
//
// What the reference consumes is the FIXPOINT of its min-label flood rounds:
// each valid pixel carries the smallest linear index of its 4-connected
// component (neighbours joined where both are valid and
// fabsf(d(p) - d(q)) <= max_diff), each invalid pixel the sink H*W. The TPU
// reaches it with one row+column flood per round and a host-visible
// convergence flag per round (~24 rounds at 4K). Here it is computed directly
// with an atomic union-find (Playne & Hawick 2018, Komura 2015), with no host
// sync at all:
//
//   srcv_speckle_labels, three launches
//     local:    one block per 32x32 tile; union-find in shared memory over
//               the tile's own edges, then every pixel stores its tile root
//               (as a global index) in parent[].
//     boundary: one thread per pixel on a tile's left or top edge; union
//               with the neighbour across the edge in device memory.
//     flatten:  parent[i] = find(i) with path halving (atomicMin writes),
//               H*W for invalid pixels. parent[] IS the label map.
//   Union always hangs the larger root under the smaller index (atomicMin),
//   so parent[x] <= x holds at all times and a component's root is its
//   smallest index: the flood's fixpoint label, whatever the order of the
//   atomics. A stale read only costs a retry (every value ever stored is an
//   ancestor), so the loops terminate.
//
//   srcv_speckle_keep: a histogram of labels over the VALID pixels only (the
//   invalid sink would put millions of atomics on one address), warp-
//   aggregated with __match_any_sync because a disparity map is mostly one
//   giant component; then keep = valid & (count[label] > max_size).
//
// What bounds it on an H100: a 4K map is 7.7 M pixels, ~40 MB of f32 + u8 +
// i32 traffic per pass (~12 us at 3.35 TB/s); the time goes to dependent
// find() chains and to atomics on the few roots of large components, not to
// bandwidth. No fast-math: the connectivity test is an exact f32 compare.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TW = 32;     // tile width  (= blockDim.x of the local kernel)
constexpr int TH = 32;     // tile height
constexpr int ROWS = 8;    // blockDim.y of the local kernel: TH / ROWS rows per thread
constexpr int THREADS = 256;

__device__ __forceinline__ bool joined(const float* __restrict__ disp,
                                       const uint8_t* __restrict__ valid,
                                       size_t i, size_t j, float max_diff) {
  return valid[j] && fabsf(disp[i] - disp[j]) <= max_diff;
}

// Union-find on a parent array in shared (tile-local indices) or device
// memory (global indices): generic pointers, so one copy serves both.
__device__ __forceinline__ int find_root(const volatile int* p, int x) {
  int y;
  while ((y = p[x]) != x) x = y;
  return x;
}

// Hangs the larger of the two roots under the smaller index. When the
// atomicMin finds that its target is no longer a root (another thread linked
// it meanwhile), it retries from the parent it found: a and b only decrease.
__device__ __forceinline__ void unite(int* p, int a, int b) {
  while (true) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(&p[b], a);
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(&p[a], b);
      if (old == a) return;
      a = old;
    }
  }
}

__global__ void __launch_bounds__(TW * ROWS)
labels_local_kernel(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                    int* __restrict__ parent, int H, int W, float max_diff) {
  __shared__ int sp[TH * TW];
  __shared__ uint8_t sc[TH * TW];  // bit 0: joined left, bit 1: joined up (in-tile)
  const int tx = threadIdx.x;
  const int x = blockIdx.x * TW + tx;
  const int y0 = blockIdx.y * TH;
#pragma unroll
  for (int r = 0; r < TH / ROWS; ++r) {
    const int ty = threadIdx.y + r * ROWS;
    const int y = y0 + ty;
    const int l = ty * TW + tx;
    sp[l] = l;
    uint8_t c = 0;
    if (x < W && y < H) {
      const size_t i = (size_t)y * W + x;
      if (valid[i]) {
        if (tx > 0 && joined(disp, valid, i, i - 1, max_diff)) c |= 1;
        if (ty > 0 && joined(disp, valid, i, i - W, max_diff)) c |= 2;
      }
    }
    sc[l] = c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TH / ROWS; ++r) {
    const int l = (threadIdx.y + r * ROWS) * TW + tx;
    const uint8_t c = sc[l];
    if (c & 1) unite(sp, l, l - 1);
    if (c & 2) unite(sp, l, l - TW);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TH / ROWS; ++r) {
    const int ty = threadIdx.y + r * ROWS;
    const int y = y0 + ty;
    if (x < W && y < H) {
      // Tile-local order is row-major like the global one, so the local
      // minimum is the global minimum of the tile component.
      const int root = find_root(sp, ty * TW + tx);
      parent[(size_t)y * W + x] = (y0 + root / TW) * W + blockIdx.x * TW + root % TW;
    }
  }
}

// Threads [0, nv) take the left edges of tile columns 1.., threads [nv, nv + nh)
// the top edges of tile rows 1...
__global__ void __launch_bounds__(THREADS)
labels_boundary_kernel(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                       int* parent, int H, int W, float max_diff, long long nv,
                       long long nh) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nv + nh) return;
  int x, y;
  size_t j;
  if (t < nv) {
    y = (int)(t % H);
    x = (int)(t / H + 1) * TW;
    j = (size_t)y * W + x - 1;
  } else {
    const long long u = t - nv;
    x = (int)(u % W);
    y = (int)(u / W + 1) * TH;
    j = (size_t)(y - 1) * W + x;
  }
  const size_t i = (size_t)y * W + x;
  if (valid[i] && joined(disp, valid, i, j, max_diff)) unite(parent, (int)i, (int)j);
}

__global__ void __launch_bounds__(THREADS)
labels_flatten_kernel(const uint8_t* __restrict__ valid, int* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    parent[i] = n;  // invalid pixels are never on another pixel's chain
    return;
  }
  // Path halving. Every value read is an ancestor of x and the root is the
  // smallest of them, so writing with atomicMin leaves each parent[i] at its
  // root whatever order the threads' compressions land in.
  const volatile int* p = parent;
  int x = i;
  while (true) {
    const int y = p[x];
    if (y == x) break;
    const int z = p[y];
    if (z == y) {
      x = y;
      break;
    }
    atomicMin(&parent[x], z);
    x = z;
  }
  if (p[i] != x) atomicMin(&parent[i], x);
}

__global__ void __launch_bounds__(THREADS)
keep_count_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ valid,
                  int* __restrict__ counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n && valid[i];
  const unsigned members = __ballot_sync(FULL, active);
  if (!active) return;
  const int lab = labels[i];
  const unsigned peers = __match_any_sync(members, lab);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&counts[lab], __popc(peers));
}

__global__ void __launch_bounds__(THREADS)
keep_test_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ valid,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep, int n,
                 int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  keep[i] = valid[i] && counts[labels[i]] > max_size;
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// disp: (H, W) f32; valid: (H, W) u8 (torch bool); labels: (H, W) i32 out.
int srcv_speckle_labels(const void* disp, const void* valid, void* labels, int H, int W,
                        float max_diff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  const uint8_t* v = (const uint8_t*)valid;
  int* p = (int*)labels;
  const dim3 tiles((W + TW - 1) / TW, (H + TH - 1) / TH);
  labels_local_kernel<<<tiles, dim3(TW, ROWS), 0, s>>>(d, v, p, H, W, max_diff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nv = (long long)H * (tiles.x - 1);
  const long long nh = (long long)W * (tiles.y - 1);
  if (nv + nh > 0) {
    labels_boundary_kernel<<<blocks_for(nv + nh), THREADS, 0, s>>>(d, v, p, H, W, max_diff,
                                                                    nv, nh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  labels_flatten_kernel<<<blocks_for((long long)H * W), THREADS, 0, s>>>(v, p, H * W);
  return (int)cudaGetLastError();
}

// labels: (n,) i32 fixpoint labels; valid: (n,) u8; counts: (n,) i32 scratch;
// keep: (n,) u8 out.
int srcv_speckle_keep(const void* labels, const void* valid, void* counts, void* keep,
                      int n, int max_size, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  keep_count_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      (const int*)labels, (const uint8_t*)valid, (int*)counts, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  keep_test_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      (const int*)labels, (const uint8_t*)valid, (const int*)counts, (uint8_t*)keep, n,
      max_size);
  return (int)cudaGetLastError();
}

}  // extern "C"
