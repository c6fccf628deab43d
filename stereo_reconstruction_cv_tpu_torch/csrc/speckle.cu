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
//     local:    one block per 32x32 tile, one warp per tile row. A pixel
//               joined to its left neighbour continues that neighbour's run:
//               the joined-left bits of a row come from one __ballot_sync,
//               and each pixel's parent is the first pixel of its run (bit
//               arithmetic, no atomics). Then union-find in shared memory
//               over the vertical edges that add something: p is united
//               with p - W unless p, p - 1, p - 1 - W and p - W form a joined
//               square (p - 1 inside the tile), whose other three edges
//               already connect them. Every pixel then stores its tile root
//               (as a global index) in parent[].
//     boundary: one thread per pixel on a tile's left or top edge; union
//               with the neighbour across the edge in device memory, skipping
//               the edges that a joined square closes the same way (on a top
//               edge with the crossed edge to its left, on a left edge with
//               the crossed edge above; never at a tile's corner pixel).
//     flatten:  parent[i] = the root of i's chain, H*W for invalid pixels.
//               parent[] IS the label map.
//   Union always hangs the larger root under the smaller index (atomicMin),
//   so parent[x] <= x holds at all times and a component's root is its
//   smallest index: the flood's fixpoint label, whatever the order of the
//   atomics. A stale read only costs a retry (every value ever stored is an
//   ancestor), so the loops terminate. find() halves the path it walks.
//   Skipping an edge keeps the components: each skipped edge is implied by
//   a chain of joined edges that ends in a kept one (ops/cuda/speckle.py:
//   reduced_connectivity is the plain mirror of the kept edge set).
//
//   srcv_speckle_keep: a histogram of labels over the VALID pixels only (the
//   invalid sink would put millions of atomics on one address), warp-
//   aggregated with __match_any_sync because a disparity map is mostly one
//   giant component; then keep = valid & (count[label] > max_size).
//
//   disp and valid are read through a row stride (in elements), so a column
//   slice of a wider map (the SGBM map without its left margin) needs no
//   copy; labels and keep are written contiguous (H, W).
//
// What bounds it on an H100: a 4K map is 7.7 M pixels, ~40 MB of f32 + u8 +
// i32 traffic per pass (~12 us at 3.35 TB/s). The first design called
// unite() for every joined edge (up to 2048 a tile), and on the main path's
// maps, nearly one component, each walked uncompressed chains and retried
// atomicMin on the same few roots: 0.146 ms on a 720p map, 1.15 ms at 4K
// for the local kernel alone. No fast-math: the connectivity test is an
// exact f32 compare.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TW = 32;     // tile width  (= blockDim.x of the local kernel)
constexpr int TH = 32;     // tile height
constexpr int ROWS = 8;    // blockDim.y of the local kernel: TH / ROWS rows per thread
constexpr int THREADS = 256;

// Pixels (y1, x1) and (y2, x2) both valid and within max_diff.
__device__ __forceinline__ bool joined(const float* __restrict__ disp,
                                       const uint8_t* __restrict__ valid, long long ds,
                                       long long vs, int y1, int x1, int y2, int x2,
                                       float max_diff) {
  return valid[y1 * vs + x1] && valid[y2 * vs + x2] &&
         fabsf(disp[y1 * ds + x1] - disp[y2 * ds + x2]) <= max_diff;
}

// Union-find on a parent array in shared (tile-local indices) or device
// memory (global indices): generic pointers, so one copy serves both. Path
// halving: x's parent is set to its grandparent as the walk passes. Only a
// non-root is written (a root is only ever written by unite's atomicMin),
// and what is written is an ancestor smaller than x, so a write that lands
// over another thread's keeps every chain intact.
__device__ __forceinline__ int find_root(volatile int* p, int x) {
  while (true) {
    const int y = p[x];
    if (y == x) return x;
    const int z = p[y];
    if (z == y) return y;
    p[x] = z;
    x = z;
  }
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
                    int* __restrict__ parent, int H, int W, long long ds, long long vs,
                    float max_diff) {
  __shared__ int sp[TH * TW];
  __shared__ float sd[TH * TW];
  __shared__ uint8_t sv[TH * TW];
  __shared__ unsigned sch[TH];  // per tile row: bit tx = joined to its left neighbour
  const int tx = threadIdx.x;
  const int x = blockIdx.x * TW + tx;
  const int y0 = blockIdx.y * TH;
  // Horizontal edges: each pixel's parent is the first pixel of its run.
#pragma unroll
  for (int r = 0; r < TH / ROWS; ++r) {
    const int ty = threadIdx.y + r * ROWS;
    const int y = y0 + ty;
    const int l = ty * TW + tx;
    bool v = false;
    float d = 0.0f;
    if (x < W && y < H) {
      v = valid[y * vs + x];
      d = disp[y * ds + x];
    }
    const float dl = __shfl_up_sync(FULL, d, 1);
    const bool vl = __shfl_up_sync(FULL, (int)v, 1);
    const bool ch = tx > 0 && v && vl && fabsf(d - dl) <= max_diff;
    const unsigned runs = __ballot_sync(FULL, ch);
    // Run starts (lanes not joined left) at or below this lane; lane 0 is one.
    const unsigned starts = ~runs & ((2u << tx) - 1u);
    sp[l] = ty * TW + 31 - __clz(starts);
    sd[l] = d;
    sv[l] = v;
    if (tx == 0) sch[ty] = runs;
  }
  __syncthreads();
  // Vertical edges inside the tile, but not those a joined square closes.
#pragma unroll
  for (int r = 0; r < TH / ROWS; ++r) {
    const int ty = threadIdx.y + r * ROWS;
    const int l = ty * TW + tx;
    if (ty > 0 && sv[l] && sv[l - TW] && fabsf(sd[l] - sd[l - TW]) <= max_diff) {
      const bool square = ((sch[ty] & sch[ty - 1]) >> tx & 1u) != 0 && sv[l - 1 - TW] &&
                          fabsf(sd[l - 1] - sd[l - 1 - TW]) <= max_diff;
      if (!square) unite(sp, l, l - TW);
    }
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
                       int* parent, int H, int W, long long ds, long long vs,
                       float max_diff, long long nv, long long nh) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nv + nh) return;
  int x, y;
  bool cross;  // the edge from (y, x) across the border
  if (t < nv) {
    y = (int)(t % H);
    x = (int)(t / H + 1) * TW;
    cross = joined(disp, valid, ds, vs, y, x, y, x - 1, max_diff);
    // Closed by the square above: both vertical edges inside their tiles,
    // and the crossing one row up.
    if (cross && y % TH != 0 && joined(disp, valid, ds, vs, y, x, y - 1, x, max_diff) &&
        joined(disp, valid, ds, vs, y, x - 1, y - 1, x - 1, max_diff) &&
        joined(disp, valid, ds, vs, y - 1, x, y - 1, x - 1, max_diff)) {
      return;
    }
    if (cross) unite(parent, y * W + x, y * W + x - 1);
  } else {
    const long long u = t - nv;
    x = (int)(u % W);
    y = (int)(u / W + 1) * TH;
    cross = joined(disp, valid, ds, vs, y, x, y - 1, x, max_diff);
    // Closed by the square to the left: both horizontal edges inside their
    // tiles, and the crossing one column left.
    if (cross && x % TW != 0 && joined(disp, valid, ds, vs, y, x, y, x - 1, max_diff) &&
        joined(disp, valid, ds, vs, y - 1, x, y - 1, x - 1, max_diff) &&
        joined(disp, valid, ds, vs, y, x - 1, y - 1, x - 1, max_diff)) {
      return;
    }
    if (cross) unite(parent, y * W + x, (y - 1) * W + x);
  }
}

__global__ void __launch_bounds__(THREADS)
labels_flatten_kernel(const uint8_t* __restrict__ valid, int* parent, int H, int W,
                      long long vs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int row = i / W;
  if (!valid[row * vs + (i - row * W)]) {
    parent[i] = H * W;  // invalid pixels are never on another pixel's chain
    return;
  }
  // Every value on the chain is an ancestor and the root, the smallest, is
  // never rewritten, so a walk that meets another thread's store still ends
  // at the root. The lanes of a tile row share one chain: compressing it on
  // the way (atomicMin) put 32 atomics on each address and was slower.
  const volatile int* p = parent;
  int x = p[i];
  while (true) {
    const int y = p[x];
    if (y == x) break;
    x = y;
  }
  parent[i] = x;
}

__global__ void __launch_bounds__(THREADS)
keep_count_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ valid,
                  int* __restrict__ counts, int H, int W, long long vs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i / W;
  const bool active = i < H * W && valid[row * vs + (i - row * W)];
  const unsigned members = __ballot_sync(FULL, active);
  if (!active) return;
  const int lab = labels[i];
  const unsigned peers = __match_any_sync(members, lab);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&counts[lab], __popc(peers));
}

__global__ void __launch_bounds__(THREADS)
keep_test_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ valid,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep, int H, int W,
                 long long vs, int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int row = i / W;
  keep[i] = valid[row * vs + (i - row * W)] && counts[labels[i]] > max_size;
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// disp: (H, W) f32, rows ds elements apart; valid: (H, W) u8 (torch bool),
// rows vs apart; labels: (H, W) i32 out, contiguous.
int srcv_speckle_labels(const void* disp, const void* valid, void* labels, int H, int W,
                        long long ds, long long vs, float max_diff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  const uint8_t* v = (const uint8_t*)valid;
  int* p = (int*)labels;
  const dim3 tiles((W + TW - 1) / TW, (H + TH - 1) / TH);
  labels_local_kernel<<<tiles, dim3(TW, ROWS), 0, s>>>(d, v, p, H, W, ds, vs, max_diff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nv = (long long)H * (tiles.x - 1);
  const long long nh = (long long)W * (tiles.y - 1);
  if (nv + nh > 0) {
    labels_boundary_kernel<<<blocks_for(nv + nh), THREADS, 0, s>>>(d, v, p, H, W, ds, vs,
                                                                    max_diff, nv, nh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  labels_flatten_kernel<<<blocks_for((long long)H * W), THREADS, 0, s>>>(v, p, H, W, vs);
  return (int)cudaGetLastError();
}

// labels: (H, W) i32 fixpoint labels, contiguous; valid: (H, W) u8, rows vs
// apart; counts: (H*W,) i32 scratch; keep: (H, W) u8 out, contiguous.
int srcv_speckle_keep(const void* labels, const void* valid, void* counts, void* keep,
                      int H, int W, long long vs, int max_size, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)H * W;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  keep_count_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      (const int*)labels, (const uint8_t*)valid, (int*)counts, H, W, vs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  keep_test_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      (const int*)labels, (const uint8_t*)valid, (const int*)counts, (uint8_t*)keep, H, W,
      vs, max_size);
  return (int)cudaGetLastError();
}

}  // extern "C"
