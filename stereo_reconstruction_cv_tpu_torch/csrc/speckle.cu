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
//   srcv_speckle_keep, two launches over count cells (one 64-bit cell per
//   pixel index, cached by the wrapper, zero between calls):
//     count: each valid pixel adds 1 to the low word of its root's cell;
//     test:  keep = valid & (low word of the label's cell > max_size), and
//            each valid pixel adds 1 to the high word, the readers. The add
//            that brings the readers up to the count is the root's last
//            reader: it stores 0, so the cells are zero again when the
//            launch ends, with no memset and no pass over all H*W cells.
//   Both passes aggregate before they touch a cell: a thread keeps a run of
//   one label over its pixels, a warp whose lanes end on one label adds
//   once, and runs of TABLE_RUN pixels or more go into a shared (label,
//   count) table that is flushed once at the end of the block; a shorter
//   run (a speckle), or one that finds no slot within PROBES, adds to its
//   cell directly, so any map stays exact. The test pass gathers every
//   pixel's count before it adds any reader, and a run or a block table
//   entry that holds all of a label's readers zeroes its cell with a plain
//   store (no atomic for a speckle inside one thread's pixels). A map
//   that is one component (the main path's nearly is) costs one global
//   atomic per block and pass, where the first design issued one per warp
//   on the same address.
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
// exact f32 compare. The size test's function moves 6 bytes a pixel (i32
// label, u8 valid in, u8 keep out), 0.0139 ms on the 4K frame; its two
// passes read the labels and valid twice, 11 bytes a pixel. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (tools/probe_sweep.py, CUDA-graph
// replay): 0.043 ms on the 4K frame, 0.32 of that bound, and 0.008-0.009 ms
// on the 720p one. The first design cleared all H*W counts per call (a
// 31 MB memset at 4K) and issued one atomic per warp on the giant
// component's root: 0.234 and 0.027 ms. Maps of many small components pay
// for the reader counts: 1.6x the first design's time on a random speckle
// map (0.021 against 0.013 ms at 720p).

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

// The keep passes: KEEP_PPT pixels a thread in groups of V (4: vector
// accesses where W % 4 == 0 and the maps are aligned; 1: any map), each
// block a contiguous range of KEEP_THREADS * KEEP_PPT pixels.
constexpr int KEEP_THREADS = 256;
constexpr int KEEP_PPT = 8;
constexpr int TABLE_BITS = 9;
constexpr int TABLE = 1 << TABLE_BITS;  // a block's (label, count) slots
constexpr int PROBES = 4;
constexpr int TABLE_RUN = 2;  // shorter runs (speckles) add to their cells directly
constexpr int EMPTY = -1;

// Adds n to a count cell: the low word in the count pass; in the test pass
// the high word, zeroing the cell when its readers reach its count.
template <bool TEST>
__device__ __forceinline__ void cell_add(unsigned long long* cells, int lab, unsigned n) {
  if (!TEST) {
    atomicAdd(&cells[lab], (unsigned long long)n);
    return;
  }
  const unsigned long long old = atomicAdd(&cells[lab], (unsigned long long)n << 32);
  if ((unsigned)(old >> 32) + n == (unsigned)old) cells[lab] = 0ull;
}

// A run of n pixels of one label: into the block's table (open addressing)
// when it is long enough and finds a slot, else straight to the cell. In the
// test pass a run that holds all `count` readers of its label (a speckle
// inside one thread's pixels) zeroes the cell with a plain store.
template <bool TEST>
__device__ __forceinline__ void run_add(int* keys, unsigned* vals, unsigned long long* cells,
                                        int lab, unsigned n, unsigned count) {
  if (TEST && n == count) {
    cells[lab] = 0ull;
    return;
  }
  if (n >= TABLE_RUN) {
    unsigned h = ((unsigned)lab * 2654435761u) >> (32 - TABLE_BITS);
    for (int p = 0; p < PROBES; ++p, h = (h + 1) & (TABLE - 1)) {
      int k = ((volatile int*)keys)[h];
      if (k == EMPTY) k = atomicCAS(&keys[h], EMPTY, lab);
      if (k == EMPTY || k == lab) {
        atomicAdd(&vals[h], n);
        return;
      }
    }
  }
  cell_add<TEST>(cells, lab, n);
}

template <int V, bool TEST>
__global__ void __launch_bounds__(KEEP_THREADS)
keep_pass_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ valid,
                 unsigned long long* cells, uint8_t* __restrict__ keep, int H, int W,
                 long long vs, int max_size) {
  constexpr int G = KEEP_PPT / V;  // groups a thread
  __shared__ int keys[TABLE];
  __shared__ unsigned vals[TABLE];
  for (int k = threadIdx.x; k < TABLE; k += KEEP_THREADS) {
    keys[k] = EMPTY;
    vals[k] = 0;
  }
  const long long n = (long long)H * W;
  const long long start = (long long)blockIdx.x * KEEP_THREADS * KEEP_PPT;
  // All loads first, so that each thread has them in flight together.
  int lab[G][V];
  uint8_t v[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long i = start + ((long long)g * KEEP_THREADS + threadIdx.x) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) v[g][j] = 0;
    if (i >= n) continue;
    const long long row = i / W;
    const uint8_t* vp = valid + row * vs + (i - row * W);
    if constexpr (V == 4) {
      const int4 t = *reinterpret_cast<const int4*>(labels + i);
      lab[g][0] = t.x; lab[g][1] = t.y; lab[g][2] = t.z; lab[g][3] = t.w;
      const uint32_t b = *reinterpret_cast<const uint32_t*>(vp);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[g][j] = (b >> (8 * j)) & 0xff;
    } else {
      lab[g][0] = labels[i];
      v[g][0] = *vp;
    }
  }
  // Test: every pixel's count (the low word of its label's cell), all
  // gathers in flight together, then keep. Each value is used before this
  // thread adds to any reader count, so no read can follow its cell's zeroing.
  const unsigned* lo = reinterpret_cast<const unsigned*>(cells);
  unsigned cnt[G][V];
  if (TEST) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < V; ++j) cnt[g][j] = v[g][j] ? lo[2 * (size_t)lab[g][j]] : 0u;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long i = start + ((long long)g * KEEP_THREADS + threadIdx.x) * V;
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        bits |= (uint32_t)(v[g][j] && (int)cnt[g][j] > max_size) << (8 * j);
      }
      if (i >= n) continue;
      if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(keep + i) = bits;
      } else {
        keep[i] = (uint8_t)bits;
      }
    }
  }
  __syncthreads();  // the table is initialised
  // The thread's run of one label over its valid pixels (test: and the
  // label's count).
  int run = EMPTY;
  unsigned run_n = 0, run_count = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!v[g][j]) continue;
      if (lab[g][j] != run) {
        if (run_n) run_add<TEST>(keys, vals, cells, run, run_n, run_count);
        run = lab[g][j];
        run_n = 0;
        if (TEST) run_count = cnt[g][j];
      }
      ++run_n;
    }
  }
  // The last runs: a warp whose lanes all end on one label adds once.
  const unsigned lane = threadIdx.x & 31;
  const unsigned has = __ballot_sync(FULL, run_n != 0);
  if (has) {
    const int src = __ffs(has) - 1;
    const int lab0 = __shfl_sync(FULL, run, src);
    if (__all_sync(FULL, run_n == 0 || run == lab0)) {
      const unsigned total = __reduce_add_sync(FULL, run_n);
      if ((int)lane == src) run_add<TEST>(keys, vals, cells, lab0, total, run_count);
    } else if (run_n) {
      run_add<TEST>(keys, vals, cells, run, run_n, run_count);
    }
  }
  __syncthreads();
  // The block's reads of the counts come before its adds to the readers.
  if (TEST) __threadfence();
  for (int k = threadIdx.x; k < TABLE; k += KEEP_THREADS) {
    const int key = keys[k];
    if (key == EMPTY) continue;
    if (TEST && vals[k] == lo[2 * (size_t)key]) {
      cells[key] = 0ull;  // all its readers are in this block
    } else {
      cell_add<TEST>(cells, key, vals[k]);
    }
  }
}

template <int V>
int keep_launches(const int* labels, const uint8_t* valid, unsigned long long* cells,
                  uint8_t* keep, int H, int W, long long vs, int max_size, cudaStream_t s) {
  const long long n = (long long)H * W;
  constexpr int chunk = KEEP_THREADS * KEEP_PPT;
  const unsigned blocks = (unsigned)((n + chunk - 1) / chunk);
  keep_pass_kernel<V, false><<<blocks, KEEP_THREADS, 0, s>>>(labels, valid, cells, keep, H, W,
                                                             vs, max_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  keep_pass_kernel<V, true><<<blocks, KEEP_THREADS, 0, s>>>(labels, valid, cells, keep, H, W,
                                                            vs, max_size);
  return (int)cudaGetLastError();
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
// apart; cells: (H*W,) u64 count cells, all zero (and zero again on return);
// keep: (H, W) u8 out, contiguous.
int srcv_speckle_keep(const void* labels, const void* valid, void* cells, void* keep,
                      int H, int W, long long vs, int max_size, void* stream) {
  if ((long long)H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && vs % 4 == 0 && (uintptr_t)labels % 16 == 0 &&
                   (uintptr_t)valid % 4 == 0 && (uintptr_t)keep % 4 == 0;
  const int* l = (const int*)labels;
  const uint8_t* v = (const uint8_t*)valid;
  unsigned long long* c = (unsigned long long*)cells;
  uint8_t* k = (uint8_t*)keep;
  return vec ? keep_launches<4>(l, v, c, k, H, W, vs, max_size, s)
             : keep_launches<1>(l, v, c, k, H, W, vs, max_size, s);
}

}  // extern "C"
