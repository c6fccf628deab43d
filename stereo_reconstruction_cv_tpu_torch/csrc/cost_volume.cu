// Fused Birchfield-Tomasi cost + box aggregation over the cropped columns.
//
// Replaces the TPU kernel stereo_reconstruction_cv_tpu/ops/pallas/cost_pallas.py
// cost_volume_pallas (kernel _producer_kernel): out[y, xc, d] equals
// block_sum(bt_cost_volume(sl, sr, rl, rr, D, min_disp)[:, x0:, :], block)
// from ops/disparity.py, as int16, with x0 = min_disp + D.
//
// Two kernels share one design and differ in their lanes:
//   - cost_volume_u8x2_kernel takes uint8 planes (ops/disparity.cost_planes
//     makes them whenever 2 * pre_filter_cap <= 255, as in every benchmark
//     cell). Each 32-bit register holds two adjacent disparities as 16-bit
//     lanes, from the staged triples through the BT cost, the ring and both
//     box sums to the store; nothing is unpacked or packed again.
//   - cost_volume_kernel takes int32 planes, one cell a 32-bit lane, for
//     planes whose values 16-bit lanes cannot hold.
//
// What bounds them on an H100: not the int16 write (2 B per cell, 4 GB at
// 3840x2160x256, 1.2 ms at 3.35 TB/s). The first design (one block of 16
// columns x 32 disparities walking every row, 27 ms at 4K x 256) recomputed
// both planes' half-pixel range of the left pixel for every disparity (12
// global loads per cell), summed the 11 horizontal taps from shared memory
// for every cell, and ran one long serial row loop per block. This design
// computes each triple once per column and slides both boxes. The int32
// kernel (6.0 ms at 4K x 256) is then bound by issuing integer
// instructions, 20-25 a cell: BT in int32 on both planes, and every 16-byte
// entry of the ring and the sums unpacked to 32-bit lanes and packed again.
// The packed kernel issues about a third of those for the same cells (per
// pair of disparities ten 16x2 min/max and seven plain operations for BT on
// both planes, one 3-input add each for the ring and the horizontal slide)
// and runs 3.7-3.9 ms at 4K x 256, 0.30 ms at 720p x 128 (PERF.md). What holds
// it there is spread over its three passes, each about a fifth of its time
// when left out (the staging loads are not: served from L1 they take as
// long), under one barrier a row at three blocks an SM, which the ring's
// shared memory sets. 16x2 min/max, their 3-input DPX forms, PRMT and IMAD
// each issue at 64 lanes a clock an SM; variants that traded shared-memory
// bytes for PRMTs (byte-staged triples), registers for fixed buffer
// addresses (the row loop unrolled by parity: two blocks an SM), or min/max
// for biased subtractions (3-input max) all ran slower.
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
// x - (min_disp + d) is clamped at the image's left edge.
//
// The packed kernel stages each left column's triple in both lanes, and
// each right column r with column r - 1 in the high lanes, so disparities
// 2k and 2k + 1 of a left column read one word per component, at the right
// column of disparity 2k. Its tiles give each vertical thread one (column,
// group) for the whole band, whose vertical sums stay in its registers
// (shared memory holds them only for the horizontal pass), each staging
// thread one item, and each horizontal thread half a run (4 disparities) of
// an odd length. Its results are exact. A plane value is a byte, so
// every triple component lies in [0, 255]. BT on one plane is the distance
// of a value to an interval, max(v, lo) - min(v, hi) per lane, which is >= 0
// in both lanes, so one 32-bit subtract is exact; the raw plane's term is
// (c >> 2) & 0x3fff3fff, and a pixel cost, Sobel term plus raw term, is at
// most 255 + 63 = 318 a lane. The ring and both box sums only add and
// subtract whole words, which is exact in each lane while every lane's true
// sum lies in [0, 65535]: no carry or borrow then crosses from the low lane
// into the high one. A box sum is at most block^2 * 318, below 65536 for
// block <= 14, which the wrapper requires of byte planes
// (ops/cuda/cost.py:u8x2_fits); check_cost_bounds holds the main path's sums
// to 32767. Each lane then holds the box sum itself, the value whose low 16
// bits the plain version keeps as int16.
//
// The int32 kernel's arithmetic is int32 and wrapping, and only the low 16
// bits are kept (the ring and the vertical sums as int16 in shared memory,
// the output): the plain version casts the pixel cost to int16 and the box
// sum back to int16, so the result is the same residue mod 2^16 for any
// int32 planes.

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

// ------------------------------------------------- uint8 planes, packed lanes

// The (v, lo, hi) words of two half-pixel triples at once (half_range3 on
// each lane): n0, v and n2 hold each lane's value at x - 1, x and x + 1.
// Lane sums stay below 2^9, so one 32-bit add and a shift whose stray bit
// is masked off give the two floor means.
__device__ __forceinline__ uint3 triple2(uint32_t n0, uint32_t v, uint32_t n2) {
  const uint32_t a = ((v + n0) >> 1) & 0x7fff7fffu;
  const uint32_t b = ((v + n2) >> 1) & 0x7fff7fffu;
  return make_uint3(v, __vimin3_u16x2(a, b, v), __vimax3_u16x2(a, b, v));
}

// Per lane, the distance of v to [lo, hi]: >= 0 in both lanes, so the 32-bit
// subtract borrows nothing across them.
__device__ __forceinline__ uint32_t dist2(uint32_t v, uint32_t lo, uint32_t hi) {
  return __vmaxu2(v, lo) - __vminu2(v, hi);
}

// Pixel costs of two disparities: symmetric BT on the Sobel plane plus BT on
// the raw plane >> 2, between a left column's words (la, lb) and a right
// pair's (ra, rb). A words: (v, lo, hi) of Sobel, v of raw; B: (lo, hi) of raw.
__device__ __forceinline__ uint32_t bt2(uint4 la, uint2 lb, uint4 ra, uint2 rb) {
  const uint32_t s = __vminu2(dist2(la.x, ra.y, ra.z), dist2(ra.x, la.y, la.z));
  const uint32_t r = __vminu2(dist2(la.w, rb.x, rb.y), dist2(ra.w, lb.x, lb.y));
  return s + ((r >> 2) & 0x3fff3fffu);
}

// a + b - c on each word: 8 packed sums slid by one step.
__device__ __forceinline__ uint4 slide(uint4 a, uint4 b, uint4 c) {
  return make_uint4(a.x + b.x - c.x, a.y + b.y - c.y, a.z + b.z - c.z, a.w + b.w - c.w);
}

// One half (4 disparities, two words) of the horizontal pass of one run:
// the box slid along `n` output columns over the vertical sums v (stride
// 2 words a column; one add and one subtract a word after the first), each
// column's 4 disparities written at o (stride D) as one 8-byte store, or
// the first `nd` (those below D) one by one.
template <bool VEC>
__device__ __forceinline__ void write_run(const uint2* v, int16_t* o, int n, int block, int nd,
                                          int D) {
  uint2 s = make_uint2(0, 0);
  for (int t = 0; t < block; ++t) s = make_uint2(s.x + v[2 * t].x, s.y + v[2 * t].y);
  for (int t = 0; t < n; ++t, o += D) {
    if (t > 0) {
      const uint2 u = v[2 * (t + block - 1)], m = v[2 * (t - 1)];
      s = make_uint2(s.x + u.x - m.x, s.y + u.y - m.y);
    }
    if constexpr (VEC) {
      *reinterpret_cast<uint2*>(o) = s;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nd) o[k] = (int16_t)((k < 2 ? s.x : s.y) >> (16 * (k & 1)));
      }
    }
  }
}

// Output columns a horizontal run covers: the least odd length that leaves
// one half run (4 disparities) a horizontal thread. Odd, so the runs a
// half-warp reads (with VS = NC + 2) fall in different banks.
__host__ __device__ inline int run_length(int TXC, int G) {
  int R = 1;
  while (2 * G * ((TXC + R - 1) / R) > B_THREADS) R += 2;
  return R;
}

// One staged item: which plane rows it reads and at which columns. A left
// column x (i < NC) reads x - 1, x, x + 1 and stages its triple in both
// lanes; a right column r reads r - 2 .. r + 1 and stages r's triple in the
// low lanes, r - 1's in the high ones. Columns are clamped to the image;
// the clamps change only lanes no output reads (every stored cell's right
// column, x - min_disp - d >= 1 with x >= x0, has both its neighbours).
struct Stager {
  const uint8_t* a;  // Sobel plane
  const uint8_t* b;  // raw plane
  int c[4];
  bool left;
};

__device__ __forceinline__ Stager make_stager(int i, const uint8_t* sl, const uint8_t* sr,
                                              const uint8_t* rl, const uint8_t* rr, int W,
                                              int Wc, int x0, int xc0, int lo, int NC,
                                              int r_min) {
  Stager s;
  s.left = i < NC;
  s.a = s.left ? sl : sr;
  s.b = s.left ? rl : rr;
  const int x = s.left ? x0 + min(max(xc0 + lo + i, 0), Wc - 1) : r_min + i - NC;
  for (int k = 0; k < 4; ++k) s.c[k] = min(max(x - 2 + k + s.left, 0), W - 1);
  return s;
}

// Row y's bytes of one plane at the item's columns.
__device__ __forceinline__ void stage_load(const Stager& s, const uint8_t* plane, size_t y,
                                           int W, uint32_t (&n)[4]) {
  const uint8_t* row = plane + y * W;
#pragma unroll
  for (int k = 0; k < 4; ++k) n[k] = __ldg(row + s.c[k]);
}

// The item's (v, lo, hi) words of one plane from its bytes.
__device__ __forceinline__ uint3 stage_words(bool left, const uint32_t (&n)[4]) {
  if (left) return triple2(n[0] * 0x10001u, n[1] * 0x10001u, n[2] * 0x10001u);
  return triple2(n[1] | n[0] << 16, n[2] | n[1] << 16, n[3] | n[2] << 16);
}

// Item i's words: A ((v, lo, hi) of Sobel, v of raw) and B ((lo, hi) of raw).
__device__ __forceinline__ void stage_store(uint4* A, uint2* B, int i, bool left,
                                            const uint32_t (&na)[4], const uint32_t (&nb)[4]) {
  const uint3 s = stage_words(left, na), r = stage_words(left, nb);
  A[i] = make_uint4(s.x, s.y, s.z, r.x);
  B[i] = make_uint2(r.y, r.z);
}

// Packed kernel. Tiles keep NC * G <= A_THREADS (one item a vertical
// thread, whose vertical sums then stay in its registers), 2 NC + 8 G - 1
// <= THREADS (one staged item a thread) and 2 G ceil(TXC / run_length) <=
// B_THREADS (one half run a horizontal thread); the launcher checks them.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cost_volume_u8x2_kernel(const uint8_t* __restrict__ sl, const uint8_t* __restrict__ sr,
                        const uint8_t* __restrict__ rl, const uint8_t* __restrict__ rr,
                        int16_t* __restrict__ out, int H, int W, int D, int min_disp,
                        int block, int G, int NC, int RB) {
  extern __shared__ uint4 smem_u8x2[];
  const int lo = -(block / 2);  // window taps [lo, hi] around a column/row
  const int hi = block - 1 + lo;
  const int DC = 8 * G;            // disparities of the block
  const int NR = NC + DC - 1;      // right columns staged
  const int NS = NC + NR;          // staged items: left columns, then right
  const int items = NC * G;        // (column, group of 8 disparities)
  const int VS = NC + 2;           // stride of a group's vertical sums (bank spread)
  const int TXC = NC - block + 1;  // output columns
  // By row parity, two buffers each of the staged words A ([2][NS] uint4)
  // and B ([2][NS] uint2, at the end) and of the vertical sums ([2][G][VS]
  // uint4: V of row j for the horizontal pass of row j + 1), then the ring
  // ([block][items] uint4). Pointers computed from the parity, not indexed
  // from an array of two: such an array would live in local memory.
  uint4* vsum = smem_u8x2 + 2 * NS;
  uint4* ring = vsum + 2 * G * VS;
  uint2* bwords = reinterpret_cast<uint2*>(ring + block * items);
  const auto A = [&](int q) { return smem_u8x2 + q * NS; };
  const auto B = [&](int q) { return bwords + q * NS; };
  const auto V = [&](int q) { return vsum + q * G * VS; };

  const int x0 = min_disp + D;
  const int Wc = W - x0;
  const int dc0 = blockIdx.x * DC;
  const int xc0 = blockIdx.y * TXC;
  const int y0 = blockIdx.z * RB;
  const int y1 = min(y0 + RB, H);
  const int j0 = y0 + lo, j1 = y1 - 1 + hi;  // rows read, unclamped
  const int tid = threadIdx.x;
  // Right column of staged item NC: the leftmost any (column, disparity) of
  // the block reaches, before clamping at the image edge (staging clamps).
  const int r_min = x0 + max(xc0 + lo, 0) - min_disp - (dc0 + DC - 1);

  // The vertical item (column, group) of thread tid < items, with its
  // vertical sums V_{j-1} in registers; its staged left column, and the
  // staged right item of its first disparity: that item's words hold
  // disparities 0 and 1 of the group, the item 2k to its left 2k and 2k + 1.
  const bool vert = tid < items;
  const int col = tid % NC;
  const int g = tid / NC;
  const int vi = g * VS + col;
  const int rs =
      NC + (x0 + min(max(xc0 + lo + col, 0), Wc - 1) - min_disp - dc0 - 8 * g - r_min);
  uint4 vs = make_uint4(0, 0, 0, 0);
  // The half run of horizontal thread th = tid - A_THREADS: words 2 hh,
  // 2 hh + 1 of group hg, output columns cb .. cb + n_out - 1 of the tile
  // (n_out = 0: none, or past D or Wc).
  const int th = tid - A_THREADS;
  const int R = run_length(TXC, G);
  const int hh = th & 1;
  const int hg = th >= 0 ? (th >> 1) % G : 0;
  const int cb = th >= 0 ? (th >> 1) / G * R : 0;
  const int dh = dc0 + 8 * hg + 4 * hh;  // the half's first disparity
  const int n_out = th >= 0 && dh < D ? max(min(R, min(TXC, Wc - xc0) - cb), 0) : 0;
  // The staged item of thread tid < NS.
  const bool stages = tid < NS;
  const Stager st = make_stager(stages ? tid : 0, sl, sr, rl, rr, W, Wc, x0, xc0, lo, NC, r_min);

  for (int i = tid; i < block * items; i += THREADS) ring[i] = make_uint4(0, 0, 0, 0);
  uint32_t na[4], nb[4];
  if (stages) {
    const size_t y = min(max(j0, 0), H - 1);
    stage_load(st, st.a, y, W, na);
    stage_load(st, st.b, y, W, nb);
    stage_store(A(j0 & 1), B(j0 & 1), tid, st.left, na, nb);
  }
  __syncthreads();

  int slot = 0;
  for (int j = j0; j <= j1; ++j) {
    const int p = j & 1;
    // Next row's plane bytes, loaded now and staged after this row's work.
    const bool next = stages && j < j1;
    if (next) {
      const size_t y = min(max(j + 1, 0), H - 1);
      stage_load(st, st.a, y, W, na);
      stage_load(st, st.b, y, W, nb);
    }
    if (vert) {
      // Pixel costs of row j, two disparities a word, and the vertical box
      // slid by one row.
      const uint4* a = A(p);
      const uint2* b = B(p);
      const uint4 la = a[col];
      const uint2 lb = b[col];
      const uint4 c = make_uint4(bt2(la, lb, a[rs], b[rs]), bt2(la, lb, a[rs - 2], b[rs - 2]),
                                 bt2(la, lb, a[rs - 4], b[rs - 4]),
                                 bt2(la, lb, a[rs - 6], b[rs - 6]));
      uint4* rg = ring + slot * items + tid;
      vs = slide(vs, c, *rg);
      *rg = c;
      V(p)[vi] = vs;
    } else if (n_out && j - 1 - hi >= y0) {
      // The output row that row j - 1 completed.
      write_run<VEC>(reinterpret_cast<const uint2*>(V(p ^ 1) + hg * VS + cb) + hh,
                     out + ((size_t)(j - 1 - hi) * Wc + xc0 + cb) * D + dh, n_out, block,
                     D - dh, D);
    }
    slot = slot + 1 == block ? 0 : slot + 1;
    if (next) stage_store(A(p ^ 1), B(p ^ 1), tid, st.left, na, nb);
    __syncthreads();
  }
  if (n_out) {  // the band's last output row, from V of row j1
    write_run<VEC>(reinterpret_cast<const uint2*>(V(j1 & 1) + hg * VS + cb) + hh,
                   out + ((size_t)(j1 - hi) * Wc + xc0 + cb) * D + dh, n_out, block, D - dh, D);
  }
}

// Dynamic shared memory of a block: triples, vertical sums and the ring.
size_t smem_bytes(int block, int G, int NC) {
  const size_t NS = 2 * (size_t)NC + 8 * G - 1;
  return sizeof(int4) * (4 * NS + 2 * (size_t)G * (NC + 1) + (size_t)block * NC * G);
}

// The same for the packed kernel: 24 B of staged words an item, not 32,
// and a vertical-sum stride of NC + 2.
size_t smem_bytes_u8x2(int block, int G, int NC) {
  const size_t NS = 2 * (size_t)NC + 8 * G - 1;
  return 48 * NS + sizeof(uint4) * (2 * (size_t)G * (NC + 2) + (size_t)block * NC * G);
}

template <typename Plane, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* sl, const void* sr, const void* rl,
           const void* rr, void* out, int H, int W, int D, int min_disp, int block, int G,
           int NC, int RB, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int Wc = W - (min_disp + D);
  const int TXC = NC - block + 1;
  // Disparity chunks innermost: the blocks of one column tile, which stage
  // overlapping right columns, run together.
  dim3 grid((D + 8 * G - 1) / (8 * G), (Wc + TXC - 1) / TXC, (H + RB - 1) / RB);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const Plane*)sl, (const Plane*)sr, (const Plane*)rl, (const Plane*)rr, (int16_t*)out,
      H, W, D, min_disp, block, G, NC, RB);
  return (int)cudaGetLastError();
}

bool bad_tile(int D, int block, int G, int NC, int RB, int vec, const void* out) {
  return G < 1 || NC < block || RB < 1 ||
         (vec && (D % 8 != 0 || (uintptr_t)out % 16 != 0));
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
  if (bad_tile(D, block, G, NC, RB, vec, out)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(block, G, NC);
  return vec ? launch<int32_t>(cost_volume_kernel<true>, smem, sl, sr, rl, rr, out, H, W, D,
                               min_disp, block, G, NC, RB, s)
             : launch<int32_t>(cost_volume_kernel<false>, smem, sl, sr, rl, rr, out, H, W, D,
                               min_disp, block, G, NC, RB, s);
}

// The same for four (H, W) uint8 planes, on the packed kernel: block <= 14
// (the lanes' range: see the head of this file), and a tile of at most one
// vertical item, one staged item and one horizontal run a thread
// (cost_tile(packed=True)).
int srcv_cost_volume_u8x2(const void* sl, const void* sr, const void* rl,
                          const void* rr, void* out, int H, int W, int D,
                          int min_disp, int block, int G, int NC, int RB, int vec,
                          void* stream) {
  const int TXC = NC - block + 1;
  if (bad_tile(D, block, G, NC, RB, vec, out) || block > 14 || NC * G > A_THREADS ||
      2 * NC + 8 * G - 1 > THREADS ||
      2 * G * ((TXC + run_length(TXC, G) - 1) / run_length(TXC, G)) > B_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes_u8x2(block, G, NC);
  return vec ? launch<uint8_t>(cost_volume_u8x2_kernel<true>, smem, sl, sr, rl, rr, out, H, W,
                               D, min_disp, block, G, NC, RB, s)
             : launch<uint8_t>(cost_volume_u8x2_kernel<false>, smem, sl, sr, rl, rr, out, H, W,
                               D, min_disp, block, G, NC, RB, s);
}

const char* srcv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
