// Fused Birchfield-Tomasi cost + box aggregation over the cropped columns.
//
// Replaces the TPU kernel stereo_reconstruction_cv_tpu/ops/pallas/cost_pallas.py
// cost_volume_pallas (kernel _producer_kernel): out[y, xc, d] equals
// block_sum(bt_cost_volume(sl, sr, rl, rr, D, min_disp)[:, x0:, :], block)
// from ops/disparity.py, as int16, with x0 = min_disp + D.
//
// What bounds it on an H100: not the int16 write (2 B per cell, 4 GB at
// 3840x2160x256, 1.2 ms at 3.35 TB/s). The first design (one block of 16
// columns x 32 disparities walking every row, 27 ms at 4K x 256) recomputed
// both planes' half-pixel range of the left pixel for every disparity (12
// global loads per cell), summed the 11 horizontal taps from shared memory
// for every cell, and ran one long serial row loop per block. This design
// computes each triple once per column and slides both boxes; what is left
// is latency within each row between barriers (chip_smoke.py's times against
// the instruction count: about a third of the issue rate), which the
// separate warps of the horizontal pass and the prefetched plane rows cut.
//
// Design: a block owns TXC cropped columns x 8G disparities x a band of RB
// output rows (plus the box's halo rows above and below), 8 warps for the
// vertical pass and 2 for the horizontal one, and walks the band's rows with
// one barrier per row. For image row j
//   - the vertical warps compute, for each (column, group of 8 disparities),
//     the 8 pixel costs from the staged half-pixel triples (v, lo, hi) of
//     both planes, and slide the vertical box: V_j = V_{j-1} + c - c_old,
//     with c_old from a ring of the last `block` rows of pixel costs;
//   - meanwhile the horizontal warps write the output row that row j - 1
//     completed: each slides the box along a run of RUN output columns over
//     V_{j-1} (one add and one subtract per cell after the first) and writes
//     each column's 8 disparities as one 16-byte store (D % 8 == 0 and an
//     aligned output; else 8 scalar stores, masked at D);
//   - then row j + 1's triples are staged, once per column (NC = TXC + block
//     - 1 left columns and the NC + 8G - 1 right columns their disparities
//     reach), from plane values loaded at the start of row j's work.
// Triples and vertical sums are double-buffered by row parity, so the one
// barrier per row orders every write before the reads that follow it.
// The window replicates at the crop origin x0 and at the right, top and
// bottom edges (block_sum on the cropped volume), and the right pixel
// x - (min_disp + d) is clamped at the image's left edge. The arithmetic is
// int32 and wrapping, and only the low 16 bits are kept (the ring and the
// vertical sums as int16 in shared memory, the output): the plain version
// casts the pixel cost to int16 and the box sum back to int16, so the result
// is the same residue mod 2^16 for any int32 planes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A_THREADS = 256;  // threads (8 warps) of the vertical pass
constexpr int B_THREADS = 64;   // threads (2 warps) of the horizontal pass
constexpr int THREADS = A_THREADS + B_THREADS;
constexpr int RUN = 4;          // output columns per thread in the horizontal pass

// (v, lo, hi) of plane row `row` at column x: the value and the min and max
// over it and its two half-pixel neighbours, clamped at the plane edge
// (_halfpixel_range; >> 1 is floor division, as in the plain version).
__device__ __forceinline__ int4 half_range(const int32_t* row, int x, int W) {
  const int v = row[x];
  const int a = (v + row[max(x - 1, 0)]) >> 1;
  const int b = (v + row[min(x + 1, W - 1)]) >> 1;
  return make_int4(v, min(min(a, b), v), max(max(a, b), v), 0);
}

// The same from the three values (x - 1, x, x + 1), edge-clamped by the caller.
__device__ __forceinline__ int4 half_range3(const int (&n)[3]) {
  const int v = n[1];
  const int a = (v + n[0]) >> 1;
  const int b = (v + n[2]) >> 1;
  return make_int4(v, min(min(a, b), v), max(max(a, b), v), 0);
}

// Symmetric BT cost of one plane between a left and a right triple.
__device__ __forceinline__ int bt(int4 l, int4 r) {
  const int c0 = max(max(l.x - r.z, r.y - l.x), 0);
  const int c1 = max(max(r.x - l.z, l.y - r.x), 0);
  return min(c0, c1);
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
}
__device__ __forceinline__ int lo16(uint32_t w) { return (int)(int16_t)(w & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t w) { return (int)w >> 16; }

// The (v, lo, hi) triples of one staged column of row y: item i < NC is left
// column i of the block, the rest right column i - NC.
struct Stage {
  const int32_t* a;  // the plane rows the item reads: Sobel, raw
  const int32_t* b;
  int x;
};

__device__ __forceinline__ Stage stage_item(int i, size_t y, const int32_t* sl,
                                            const int32_t* sr, const int32_t* rl,
                                            const int32_t* rr, int W, int Wc, int x0,
                                            int xc0, int lo, int NC, int r_min) {
  if (i < NC) return {sl + y * W, rl + y * W, x0 + min(max(xc0 + lo + i, 0), Wc - 1)};
  return {sr + y * W, rr + y * W, min(max(r_min + i - NC, 0), W - 1)};
}

// Slot of item i's triples in a triple buffer: [2][NC] left, then [2][NR] right.
__device__ __forceinline__ int4* stage_slot(int4* buf, int i, int NC, int NR) {
  return i < NC ? buf + i : buf + 2 * NC + (i - NC);
}

// The 8 values of an int16 x 8 entry, sign-extended.
__device__ __forceinline__ void unpack8(uint4 w, int (&v)[8]) {
  v[0] = lo16(w.x); v[1] = hi16(w.x); v[2] = lo16(w.y); v[3] = hi16(w.y);
  v[4] = lo16(w.z); v[5] = hi16(w.z); v[6] = lo16(w.w); v[7] = hi16(w.w);
}
__device__ __forceinline__ uint4 pack8(const int (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// Horizontal pass for output row yo, on the B_THREADS threads tb: each (run
// of RUN columns, group of 8 disparities) slides the box along its run over
// the vertical sums V ([G][VS] entries of 8 x int16).
template <bool VEC>
__device__ __forceinline__ void horizontal_pass(const uint4* V, int16_t* out, int yo,
                                                int tb, int Wc, int D, int xc0, int dc0,
                                                int block, int G, int NC, int VS) {
  const int TXC = NC - block + 1;
  const int runs = (TXC + RUN - 1) / RUN;
  for (int i = tb; i < runs * G; i += B_THREADS) {
    const int g = i % G;
    const int cb = (i / G) * RUN;
    const int d0 = dc0 + 8 * g;
    if (d0 >= D) continue;
    const uint4* v = V + g * VS + cb;
    int s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int t = 0; t < block; ++t) {
      int u[8];
      unpack8(v[t], u);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += u[k];
    }
    for (int t = 0; t < RUN; ++t) {
      const int xc = xc0 + cb + t;
      if (cb + t >= TXC || xc >= Wc) break;
      if (t > 0) {
        int u[8], m[8];
        unpack8(v[t + block - 1], u);
        unpack8(v[t - 1], m);
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] += u[k] - m[k];
      }
      int16_t* o = out + ((size_t)yo * Wc + xc) * D + d0;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(o) = pack8(s);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (d0 + k < D) o[k] = (int16_t)s[k];
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cost_volume_kernel(const int32_t* __restrict__ sl, const int32_t* __restrict__ sr,
                   const int32_t* __restrict__ rl, const int32_t* __restrict__ rr,
                   int16_t* __restrict__ out, int H, int W, int D, int min_disp,
                   int block, int G, int NC, int RB) {
  extern __shared__ int4 smem[];
  const int lo = -(block / 2);  // window taps [lo, hi] around a column/row
  const int hi = block - 1 + lo;
  const int DC = 8 * G;            // disparities of the block
  const int NR = NC + DC - 1;      // right columns staged
  const int NS = NC + NR;          // staged columns
  const int items = NC * G;        // (column, group of 8 disparities)
  const int VS = NC + 1;           // stride of a group's vertical sums (bank spread)
  // Two buffers each of triples (by row parity: [2][NC] left, [2][NR] right
  // int4) and of vertical sums ([G][VS] x 8 int16; V of row j is written
  // from V of row j - 1), then the ring ([block][items] x 8 int16). Pointers
  // computed from the parity, not indexed from an array of two: such an
  // array would live in local memory.
  const auto tri = [&](int q) { return smem + q * 2 * NS; };
  uint4* vsum = reinterpret_cast<uint4*>(smem + 4 * NS);
  const auto V = [&](int q) { return vsum + q * G * VS; };
  uint4* ring = vsum + 2 * G * VS;

  const int x0 = min_disp + D;
  const int Wc = W - x0;
  const int dc0 = blockIdx.x * DC;
  const int xc0 = blockIdx.y * (NC - block + 1);
  const int y0 = blockIdx.z * RB;
  const int y1 = min(y0 + RB, H);
  const int j0 = y0 + lo, j1 = y1 - 1 + hi;  // rows read, unclamped
  const int tid = threadIdx.x;
  const bool horiz = tid >= A_THREADS;       // the warps of the horizontal pass
  // Right column of staged item NC: the leftmost any (column, disparity) of
  // the block reaches, before clamping at the image edge (staging clamps).
  const int r_min = x0 + max(xc0 + lo, 0) - min_disp - (dc0 + DC - 1);

  for (int i = tid; i < 2 * G * VS + block * items; i += THREADS) {
    vsum[i] = make_uint4(0, 0, 0, 0);  // both V buffers and the ring
  }
  for (int i = tid; i < NS; i += THREADS) {
    const Stage s = stage_item(i, min(max(j0, 0), H - 1), sl, sr, rl, rr, W, Wc, x0,
                               xc0, lo, NC, r_min);
    int4* t = stage_slot(tri(j0 & 1), i, NC, NR);
    t[0] = half_range(s.a, s.x, W);
    t[i < NC ? NC : NR] = half_range(s.b, s.x, W);
  }
  __syncthreads();

  int slot = 0;
  for (int j = j0; j <= j1; ++j) {
    const int p = j & 1;
    // Next row's plane values, loaded now and staged after this row's work.
    const bool next = j < j1 && tid < NS;
    int na[3], nb[3];
    if (next) {
      const Stage s = stage_item(tid, min(max(j + 1, 0), H - 1), sl, sr, rl, rr, W, Wc,
                                 x0, xc0, lo, NC, r_min);
      na[0] = s.a[max(s.x - 1, 0)]; na[1] = s.a[s.x]; na[2] = s.a[min(s.x + 1, W - 1)];
      nb[0] = s.b[max(s.x - 1, 0)]; nb[1] = s.b[s.x]; nb[2] = s.b[min(s.x + 1, W - 1)];
    }
    if (horiz) {
      // The output row that row j - 1 completed.
      if (j - 1 - hi >= y0) {
        horizontal_pass<VEC>(V(p ^ 1), out, j - 1 - hi, tid - A_THREADS, Wc, D, xc0, dc0,
                             block, G, NC, VS);
      }
    } else {
      // Pixel costs of row j, and the vertical box slid by one row.
      const int4* lt = tri(p);
      const int4* rt = tri(p) + 2 * NC;
      for (int i = tid; i < items; i += A_THREADS) {
        const int col = i % NC;
        const int g = i / NC;
        const int x = x0 + min(max(xc0 + lo + col, 0), Wc - 1);
        const int4 ls = lt[col];
        const int4 lr = lt[NC + col];
        // Staged right column of this column at the group's first disparity;
        // disparity k of the group reads the k-th one to its left.
        const int4* rs = rt + (x - min_disp - dc0 - 8 * g - r_min);
        int c[8], old[8], v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = bt(ls, rs[-k]) + (bt(lr, rs[NR - k]) >> 2);
        uint4* rg = ring + slot * items + i;
        unpack8(*rg, old);
        *rg = pack8(c);
        const int vi = g * VS + col;
        unpack8(V(p ^ 1)[vi], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += c[k] - old[k];
        V(p)[vi] = pack8(v);
      }
    }
    slot = slot + 1 == block ? 0 : slot + 1;
    if (next) {
      int4* t = stage_slot(tri(p ^ 1), tid, NC, NR);
      t[0] = half_range3(na);
      t[tid < NC ? NC : NR] = half_range3(nb);
    }
    for (int i = tid + THREADS; j < j1 && i < NS; i += THREADS) {  // tiles wider than a block
      const Stage s = stage_item(i, min(max(j + 1, 0), H - 1), sl, sr, rl, rr, W, Wc,
                                 x0, xc0, lo, NC, r_min);
      int4* t = stage_slot(tri(p ^ 1), i, NC, NR);
      t[0] = half_range(s.a, s.x, W);
      t[i < NC ? NC : NR] = half_range(s.b, s.x, W);
    }
    __syncthreads();
  }
  if (horiz) {
    horizontal_pass<VEC>(V(j1 & 1), out, j1 - hi, tid - A_THREADS, Wc, D, xc0, dc0, block,
                         G, NC, VS);
  }
}

// Dynamic shared memory of a block: triples, vertical sums and the ring.
size_t smem_bytes(int block, int G, int NC) {
  const size_t NS = 2 * (size_t)NC + 8 * G - 1;
  return sizeof(int4) * (4 * NS + 2 * (size_t)G * (NC + 1) + (size_t)block * NC * G);
}

template <bool VEC>
int launch(const void* sl, const void* sr, const void* rl, const void* rr, void* out,
           int H, int W, int D, int min_disp, int block, int G, int NC, int RB,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(block, G, NC);
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int Wc = W - (min_disp + D);
  const int TXC = NC - block + 1;
  // Disparity chunks innermost: the blocks of one column tile, which stage
  // overlapping right columns, run together.
  dim3 grid((D + 8 * G - 1) / (8 * G), (Wc + TXC - 1) / TXC, (H + RB - 1) / RB);
  cost_volume_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      (const int32_t*)sl, (const int32_t*)sr, (const int32_t*)rl, (const int32_t*)rr,
      (int16_t*)out, H, W, D, min_disp, block, G, NC, RB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Planes: four (H, W) int32, contiguous, border-pinned by the caller.
// out: (H, W - min_disp - D, D) int16, contiguous. Tile (ops/cuda/cost.py
// cost_tile): G groups of 8 disparities, NC >= block staged columns, bands
// of RB output rows. vec = 1: 16-byte stores, which need D % 8 == 0 and a
// 16-byte aligned out.
int srcv_cost_volume(const void* sl, const void* sr, const void* rl,
                     const void* rr, void* out, int H, int W, int D,
                     int min_disp, int block, int G, int NC, int RB, int vec,
                     void* stream) {
  if (G < 1 || NC < block || RB < 1 ||
      (vec && (D % 8 != 0 || (uintptr_t)out % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(sl, sr, rl, rr, out, H, W, D, min_disp, block, G, NC, RB, s)
             : launch<false>(sl, sr, rl, rr, out, H, W, D, min_disp, block, G, NC, RB, s);
}

const char* srcv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
