// The probe kernels P1-P9: Hopper counterparts of the Pallas kernels of the
// JAX package's probe tools (tools/pallas_probe.py, scatter_microbench.py,
// vpu_probe.py). They compute what those TPU kernels compute, bit for bit,
// and are timed by the port's tools (lidar_slam_tpu_torch/tools/).
//
//   P1 smem_stream         pallas_probe.py::v1_smem_stream (:38)
//   P2 dynamic_store       pallas_probe.py::v2_dynamic_store (:64)
//   P3 dynamic_lane_store  pallas_probe.py::v3_dynamic_lane_store (:92)
//   P4 masked_tile         pallas_probe.py::v4_masked_tile (:122)
//   P5 scalar_sum          pallas_probe.py::v5_vmem_scalar_read (:159)
//   P6 fill                pallas_probe.py::v6_full_grid_vmem (:176)
//   P7 tile_rmw            scatter_microbench.py::mb_rmw_kernel (:71)
//   P8 segment_rmw         scatter_microbench.py::mb_seg_kernel (:115)
//   P9 vpu_loop            vpu_probe.py::make_kernel (:76), six modes
//
// Ordering. The TPU kernels run their grid steps in order on one core and
// zero the output under program_id == 0; here a loop inside the block
// takes the place of the grid, and each kernel writes its whole output.
//
// Exactness without float atomics. Every probe adds in a fixed order
// (update order, segment order or emit order). P1-P4 and P9: the TPU tiles
// are (8, 128) or (64, 128), always at offsets that are multiples of the
// tile, so a cell has one tile-local position (s, l) whatever tile covers
// it. In P9 a thread owns one cell of one tile position and does its
// adds. No other thread touches them, so each cell's float32 sum is the
// sequential one. P1 and P5 fold in index order in one warp (P1's tile
// cells all hold the same fold). The TPU's masked RMW also adds
// 0.0 to the rest of the tile; x + 0.0 == x for every x except -0.0 and
// NaN, which no probe's grid holds (it starts at +0.0 or at finite random
// values, and a round-to-nearest sum of nonzero terms is never -0.0), so
// those adds are skipped. P7 partitions its updates stably by cell; P2-P4
// and P8 count (below). Cells outside the grid are dropped (the tools
// never produce them).
//
// What bounds them on an H100. P1-P5 move under 70 KB: one launch, a few
// microseconds. P6 writes the padded 1208 x 1216 grid (5.9 MB): bytes,
// about 1.8 us at 3.35 TB/s; the grid exceeds the 227 KB of shared memory
// a block can use and fits the 50 MB L2. P7 and P8 read their updates
// (12 or 16 B each) and write the grid once: bytes. P9 reads its word table
// and reads and writes its grid (512 x 512, 1 MB) once: bytes, under a
// microsecond; what it measures is the cost of a masked (64, 128) tile
// visit, spread over the card.
//
// Designs. P1: 16-byte stores over several blocks; the blocks whose cells
// hold tile cells fold the entries in one warp first (see "P1" below).
// P2-P4: a block for each (8, 128) tile position, counting (see "P2, P3,
// P4" below). P5: one warp, an in-order fold. P6: 16-byte stores from
// the first 16-byte boundary (a scalar head before it and a scalar tail
// after the last whole float4), a float4 a thread, the grid sized from the
// element count and capped at sixteen 256-thread blocks an SM. P7, P8:
// see "P7 and P8" below. P9: see "P9" below (the TPU kernel's grid=(1,)
// was the whole v5e chip; one block is 1/132 of an H100, so the new design
// spreads the tiles' cells over the card and keeps each cell in a
// register).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TS = 8;      // rows of the (8, 128) tile
constexpr int TL = 128;    // lanes of a tile (both tile shapes)
constexpr int TILE_THREADS = TS * TL;  // one thread per (8, 128) position
constexpr unsigned ALL_LANES = 0xffffffffu;

constexpr int VS = 64;  // rows of P9's (64, 128) tile
constexpr int RAY_W_MAX = 4096;  // P9's ray modes wrap the word table
constexpr int SEG_THREADS = 256;  // P8's block

enum VpuMode { RMW = 0, VEC = 1, FULL = 2, FULLV = 3, RAY1 = 4, RAY2 = 5 };

// S_k: k sequential __fadd_rn of val from +0.0 (P4, P8).
__device__ __forceinline__ float k_fold_sum(int k, float val) {
  float acc = 0.f;
  for (int i = 0; i < k; ++i) acc = __fadd_rn(acc, val);
  return acc;
}

// The in-order float32 fold ((+0.0 + xs[0]) + xs[1]) + ... of xs, by the
// 32 lanes of one warp (P1, P5): lane j loads entry j of each chunk of 32
// (coalesced; the next chunk's load in flight while this one is folded),
// and every lane folds the chunk's values in lane order, each broadcast by
// __shfl_sync, so the sum is the sequential one, bit for bit. Every lane
// returns it. +0.0 + -0.0 is +0.0, as in the plain versions.
__device__ __forceinline__ float warp_fold(const float* __restrict__ xs,
                                           int n) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  float v = lane < n ? xs[lane] : 0.f;
  for (int left = n; left > 0; left -= 32, xs += 32) {
    const float next = lane + 32 < left ? xs[lane + 32] : 0.f;
    if (left >= 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc = __fadd_rn(acc, __shfl_sync(ALL_LANES, v, j));
    } else {
      for (int j = 0; j < left; ++j)
        acc = __fadd_rn(acc, __shfl_sync(ALL_LANES, v, j));
    }
    v = next;
  }
  return acc;
}

// -- P1: fold once, then write --------------------------------------------
//
// Replaced: pallas_probe.py::v1_smem_stream (:38), the static tile
// [0, 8) x [0, 128) of a VMEM-resident zero grid += xs[i] for every i in
// order, a scalar read from SMEM a step. Every tile cell takes the same
// adds from +0.0, so each holds the in-order fold of xs and every other
// cell +0.0. Bound on an H100: bytes, the entries read once and the
// 64 x 256 grid written once (0.00002 ms at the tool's 64 entries), so the
// launch floor; past a few hundred entries the chain of n dependent adds
// (about 5 ns each, as P5's). The one-block design zeroed the grid itself
// and then made n dependent global read-add-writes of 16 cells a thread.
//
// Here a float4 a thread, P1_THREADS a block, over the W x H grid (W * H a
// multiple of 4). A block whose cells hold no tile cell writes its zeros at
// once; a block whose cells do (two on the 64 x 256 grid) folds the
// entries in its first warp (warp_fold; n adds, no grid barrier: each such
// block folds them itself), passes the sum through shared memory, and
// writes it to its tile cells and zeros to the rest.
constexpr int P1_THREADS = 256;

// Whether the cells [c0, c1) of a W x H grid hold a cell of the static
// tile [0, 8) x [0, 128); the same for every thread of a block.
__device__ __forceinline__ bool holds_tile(long long c0, long long c1, int W,
                                           int H) {
  const int tw = W < TS ? W : TS, th = H < TL ? H : TL;
  for (long long x = c0 / H; x < tw && x * H < c1; ++x)
    if (x * H + th > c0) return true;
  return false;
}

__global__ void __launch_bounds__(P1_THREADS)
smem_stream_kernel(const float* __restrict__ xs, int n,
                   float* __restrict__ out, int W, int H) {
  __shared__ float sum;
  const long long cells = (long long)W * H;
  const long long e = (long long)blockIdx.x * P1_THREADS + threadIdx.x;
  const long long c0 = (long long)blockIdx.x * P1_THREADS * 4;
  const long long c1 = c0 + 4LL * P1_THREADS < cells ? c0 + 4LL * P1_THREADS
                                                     : cells;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds_tile(c0, c1, W, H)) {
    if (threadIdx.x < 32) {
      const float acc = warp_fold(xs, n);
      if (threadIdx.x == 0) sum = acc;
    }
    __syncthreads();
    const float v = sum;
    if (4 * e < cells) {
      const int x = (int)(4 * e / H), y = (int)(4 * e % H);
      // H % 4 == 0 is not assumed: a float4 may end past its row
      float f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yk = y + k, xk = x + yk / H;
        f[k] = xk < TS && yk % H < TL ? v : 0.f;
      }
      q = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  if (4 * e < cells) reinterpret_cast<float4*>(out)[e] = q;
}

// -- P2, P3, P4: count, then write once ----------------------------------
//
// Replaced: pallas_probe.py::v2_dynamic_store (:64), v3_dynamic_lane_store
// (:92) and v4_masked_tile (:122), one (8, 128) tile RMW per entry, in
// order, into a VMEM-resident zero grid: +1.0 to the whole tile at
// (floor(x / 8) * 8, 0) (P2) or (floor(x / 8) * 8, floor(y / 128) * 128)
// (P3), and -1.386 to the one cell (x, y) of that tile that P4's mask lets
// through. Bound on an H100: bytes, the entries read once and the 64 x 256
// grid written once (0.00002 ms at the tool's 64 entries): launch-bound.
// The one-block designs walked the entries in turn, each a dependent
// global read-add-write of 16 cells a thread (6-10 us on the device; the
// launch floor is 1.2).
//
// Every add of a probe is the same value into a zero grid, so a cell hit
// k times holds S_k, the k-fold float32 sum of that value from +0.0,
// whatever the order of the entries. In P2 and P3 k counts the entries on
// the cell's tile, and S_k = min(k, 2^24) exactly (float32 holds every
// integer to 2^24, and 2^24 + 1 rounds to even, back to 2^24). In P4 k
// counts the entries on the cell itself, and S_k is k sequential adds of
// -1.386 (k_fold_sum; the argument P8 uses). So a block of 1,024 threads
// for each tile position (16 on the tool's grid), thread (s, l) owning the
// position's cell (s, l): the threads take the entries strided (coalesced
// loads) and count the tile's hits in integers, and each writes its cell
// once. P2 and P3 sum one count a tile by a warp reduction and the 32 warp
// sums in shared memory; P4 keeps a counter a cell in shared memory and
// adds to it by integer atomics. Integer counts need no order. P2's
// entries all lie on lane tile 0, so its other blocks read nothing and
// write zeros. An entry's tile is (x >> 3, y >> 7), an arithmetic shift
// (floor division, as the plain versions'): an entry off the grid's tiles
// counts for none (P4 reads x & 7 and y & 127 only after the tile test),
// and cells past a partial edge tile are not written. What stays serial
// is P4's chain of k dependent adds a cell: at most one at the tool's 64
// entries, tens on a hot tile, about 5 ns an add.

// P2 and P3: the hits of the block's tile (tx, ty) among the n entries,
// (xs[i] >> 3, ys[i] >> 7) == (tx, ty), each of its cells written once as
// S_k. With no ys (P2, HAS_YS false) every entry lies on lane tile 0, and
// a block at ty > 0 reads nothing and writes zeros. HAS_YS is a template
// argument so that P3's loop tests no pointer at run time.
template <bool HAS_YS>
__device__ __forceinline__ void write_tile_hits(
    const int32_t* __restrict__ xs, const int32_t* __restrict__ ys, int n,
    float* __restrict__ out, int W, int H) {
  __shared__ unsigned warp_hits[TILE_THREADS / 32];
  __shared__ unsigned hits;
  const int TY = (H + TL - 1) / TL;
  const int tx = blockIdx.x / TY, ty = blockIdx.x % TY;
  unsigned k = 0;
  if (HAS_YS || ty == 0) {  // block-uniform
    for (int i = threadIdx.x; i < n; i += TILE_THREADS)
      k += (xs[i] >> 3) == tx && (!HAS_YS || (ys[i] >> 7) == ty);
    k = __reduce_add_sync(ALL_LANES, k);
    if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = k;
    __syncthreads();
    if (threadIdx.x < 32) {
      k = __reduce_add_sync(ALL_LANES, warp_hits[threadIdx.x]);
      if (threadIdx.x == 0) hits = k;
    }
    __syncthreads();
    k = hits;
  }
  const int x = tx * TS + threadIdx.x / TL, y = ty * TL + threadIdx.x % TL;
  if (x < W && y < H)
    out[(size_t)x * H + y] = (float)min(k, 1u << 24);  // S_k
}

// P2: rows [x8, x8 + 8) x lanes [0, 128) += 1, x8 = floor(x / 8) * 8.
__global__ void __launch_bounds__(TILE_THREADS)
dynamic_store_kernel(const int32_t* __restrict__ xs, int n,
                     float* __restrict__ out, int W, int H) {
  write_tile_hits<false>(xs, nullptr, n, out, W, H);
}

// P3: as P2 on the tile at lane offset floor(y / 128) * 128.
__global__ void __launch_bounds__(TILE_THREADS)
dynamic_lane_store_kernel(const int32_t* __restrict__ xs,
                          const int32_t* __restrict__ ys, int n,
                          float* __restrict__ out, int W, int H) {
  write_tile_hits<true>(xs, ys, n, out, W, H);
}

// P4: cell (x, y) += val, the one cell of the tile's mask.
__global__ void __launch_bounds__(TILE_THREADS)
masked_tile_kernel(const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys, int n, float val,
                   float* __restrict__ out, int W, int H) {
  __shared__ unsigned hits[TILE_THREADS];  // cell (s, l) at s * TL + l
  const int TY = (H + TL - 1) / TL;
  const int tx = blockIdx.x / TY, ty = blockIdx.x % TY;
  hits[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += TILE_THREADS) {
    const int x = xs[i], y = ys[i];
    if ((x >> 3) == tx && (y >> 7) == ty)
      atomicAdd(&hits[(x & (TS - 1)) * TL + (y & (TL - 1))], 1u);
  }
  __syncthreads();
  const int x = tx * TS + threadIdx.x / TL, y = ty * TL + threadIdx.x % TL;
  if (x < W && y < H)
    out[(size_t)x * H + y] = k_fold_sum((int)hits[threadIdx.x], val);
}

// P5: the in-order float32 sum of xs. Replaced:
// pallas_probe.py::v5_vmem_scalar_read (:159), a scalar fori_loop over a
// VMEM ref. Bound: one dependent add after another; at the tool's 32
// entries the launch floor. One warp folds them (warp_fold). Past the
// floor the chain of dependent adds bounds it, about 5 ns an add on an
// H100 (a fold from shared memory is no faster; one thread loading as it
// adds, the one-thread design, is 2.3x slower).

__global__ void __launch_bounds__(32)
scalar_sum_kernel(const float* __restrict__ xs, int n,
                  float* __restrict__ out) {
  const float acc = warp_fold(xs, n);
  if (threadIdx.x == 0) out[0] = acc;
}

// P6: out[0, n) = val. The `head` elements before the first 16-byte
// boundary and the tail after the n4 whole float4s of the body are written
// one at a time (at most three each); the body a float4 a thread.
constexpr int FILL_THREADS = 256;

__global__ void __launch_bounds__(FILL_THREADS)
fill_kernel(float* __restrict__ out, size_t head, size_t n4, size_t n,
            float val) {
  const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  float4* body = reinterpret_cast<float4*>(out + head);
  const float4 v4 = make_float4(val, val, val, val);
  for (size_t e = tid; e < n4; e += (size_t)gridDim.x * blockDim.x)
    body[e] = v4;
  if (tid < head) out[tid] = val;
  if (tid < n - head - 4 * n4) out[head + 4 * n4 + tid] = val;
}

// -- P7 and P8: partition, then order ------------------------------------
//
// Replaced: scatter_microbench.py::mb_rmw_kernel (:71, P7) and
// mb_seg_kernel (:115, P8), one (8, 128) tile RMW per update or segment
// into a VMEM-resident grid, in order. Bound on an H100: bytes, the
// updates read once (12 B an update, 16 B a segment) and the grid written
// once: 0.00411 ms (P7, u = 657,408) and 0.00215 ms (P8, 82,432 segments).
//
// P7 is order-dependent: its values are +-1.386 and mixed (any float32 in
// general), and float32 addition does not associate, so each cell's adds
// must run in update order. The design partitions the updates stably
// (never scanning all of them in every block):
//   1. tile_rmw_count_kernel: a block takes a chunk of BIN_BT * BIN_IPT
//      updates, counts them per owner tile (OR x OC cells) and ranks each
//      among the earlier updates of its owner in the chunk (stable_rank);
//      writes the (owner, chunk) counts and the ranks;
//   2. tile_rmw_scan_kernel: per owner, the exclusive prefix of its counts
//      over the chunks (a warp scan), and its total;
//   3. tile_rmw_fill_kernel: each block scans the owner totals into list
//      bases (block 0 writes them out, each owner's first window of
//      OR * OC * OWN_IPT entries and each window's owner) and writes
//      every in-grid update, as (cell in the owner tile, value), at base +
//      chunk prefix + rank: each owner's list in update order, with no
//      atomics;
//   4. tile_rmw_sort_kernel: a block a window, all owners' windows at
//      once: sorts the window by cell stably in shared memory (stable_rank
//      again, a scan of the cell counts, a scatter to global memory);
//   5. tile_rmw_sum_kernel: a block an owner, a thread a cell: stages the
//      owner's sorted windows in shared memory in order and adds its
//      cell's runs with __fadd_rn in a register, then writes the cell, so
//      the block writes its whole tile, zeros included, and nothing zeroes
//      the grid first.
// No block reads another owner's updates, and no barrier round is spent a
// 1,024 updates in every block; a hot owner's windows sort in parallel,
// and only its ordered adds stay in one block. On the tool's updates the
// sort and sum passes bound the whole: about 1,600 blocks of 1,024
// threads each, two a multiprocessor, each about ten barrier phases long.

// P8 is order-free: every add is the same val into a grid that starts at
// +0.0, so a cell hit k times holds S_k = fl(...fl(fl(0 + val) + val)...)
// (k adds), whatever the order of the segments. So one cooperative kernel
// zeroes the output viewed as int32 counts, counts the hits of each cell
// with integer atomics, and turns each count k into S_k by k sequential
// __fadd_rn, a grid barrier between the passes (one launch: the host's
// launch path costs more than the device's work at the tool's size).
// A float atomicAdd(val) would not do: PTX atom.add.f32 flushes subnormal
// inputs and results, so it is not exact for every val.

// The exclusive prefix of v over the block's BT threads (BT a multiple of
// 32); total gets the sum. warp_sums holds 32 ints. Barriers inside; the
// last one lets the caller reuse warp_sums at once.
template <int BT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(ALL_LANES, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < BT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(ALL_LANES, s, d);
      if (lane >= d) s += t;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[BT / 32 - 1];
  const int before = w > 0 ? warp_sums[w - 1] : 0;
  __syncthreads();
  return before + incl - v;
}

// Row stride of stable_rank's per-warp counts for nb bins: a multiple of 8
// uint16 (16 bytes).
__host__ __device__ constexpr int hist_stride(int nb) { return (nb + 7) & ~7; }

// Stable counting rank over a block. Item j of thread (warp w, lane l) is
// item w * 32 IPT + 32 j + l of the block's sequence of n items; key[j] is
// its bin in [0, nb), or -1 for none (and for every item past n). rank[j]
// gets the number of earlier items of the sequence in the same bin,
// totals[b * stride] the count of bin b (a shared or a global pointer).
// hist is BT / 32 rows of hist_stride(nb) uint16 in shared memory:
// per-warp counts, then per-warp prefixes; only the warps that hold items
// use their rows. A warp ranks its 32 items a round by __match_any_sync
// and its own counts, in order; then each bin's counts are prefixed across
// the warps. The counts are order-free integers; the ranks keep the
// sequence order. Ends after a barrier.
template <int BT, int IPT>
__device__ __forceinline__ void stable_rank(const int (&key)[IPT], int n,
                                            int nb, uint16_t* hist,
                                            int* __restrict__ totals,
                                            int stride, int (&rank)[IPT]) {
  constexpr int NW = BT / 32;
  static_assert(NW % 8 == 0, "the prefix loop takes 8 rows at a time");
  const int nw = min(NW, (n + 32 * IPT - 1) / (32 * IPT));
  const int hs = hist_stride(nb);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint4* h128 = reinterpret_cast<uint4*>(hist);
  for (int e = threadIdx.x; e < nw * hs / 8; e += BT)
    h128[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  uint16_t* mine = hist + w * hs;
  const unsigned lower = (1u << lane) - 1u;
  if (w < nw) {  // the other warps hold no items
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int k = key[j];
      const unsigned peers = __match_any_sync(ALL_LANES, k);
      const int leader = __ffs(peers) - 1;
      int old = 0;
      if (k >= 0 && lane == leader) {
        old = mine[k];
        mine[k] = (uint16_t)(old + __popc(peers));
      }
      rank[j] = __shfl_sync(ALL_LANES, old, leader) + __popc(peers & lower);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += BT) {
    int run = 0;
#pragma unroll
    for (int v0 = 0; v0 < NW; v0 += 8) {
      if (v0 >= nw) break;
      int c[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        c[q] = v0 + q < nw ? hist[(v0 + q) * hs + b] : 0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (v0 + q < nw) {
          hist[(v0 + q) * hs + b] = (uint16_t)run;
          run += c[q];
        }
    }
    totals[(size_t)b * stride] = run;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    if (key[j] >= 0) rank[j] += mine[key[j]];
}

// P7's owner tile (the TPU's 8 x 128 tile; 16 x 16 owners measured 1.7x
// slower, their binning carrying 5,776 owner bins a chunk), its binning
// blocks and its windows.
struct Own {
  static constexpr int OR = 8, OC = 128;  // owner rows, columns
  static constexpr int CELLS = OR * OC;  // a thread a cell in passes 4, 5
  static constexpr int BIN_BT = 1024, BIN_IPT = 8;  // binning blocks
  static constexpr int OWN_IPT = 4;  // window: OR * OC * OWN_IPT entries
};

// P7 pass 1: per chunk, each owner's count (table[owner][chunk], the table
// owner-major) and each in-grid update's rank among its owner's earlier
// updates in the chunk.
__global__ void __launch_bounds__(Own::BIN_BT)
tile_rmw_count_kernel(const int32_t* __restrict__ xs,
                      const int32_t* __restrict__ ys, int u, int W, int H,
                      int n_owners, int* __restrict__ table,
                      uint16_t* __restrict__ ranks) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int IPT = Own::BIN_IPT;
  const int OH = (H + Own::OC - 1) / Own::OC;
  const int first = blockIdx.x * Own::BIN_BT * IPT +
                    (threadIdx.x >> 5) * 32 * IPT + (threadIdx.x & 31);
  int key[IPT], rank[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = first + 32 * j;
    key[j] = -1;
    if (i < u) {
      const int x = xs[i], y = ys[i];
      if (x >= 0 && x < W && y >= 0 && y < H)
        key[j] = x / Own::OR * OH + y / Own::OC;
    }
  }
  stable_rank<Own::BIN_BT, IPT>(key, u - blockIdx.x * Own::BIN_BT * IPT,
                              n_owners, reinterpret_cast<uint16_t*>(smem),
                              table + blockIdx.x, gridDim.x, rank);
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    if (key[j] >= 0) ranks[first + 32 * j] = (uint16_t)rank[j];
}

// P7 pass 2: per owner (a warp), the exclusive prefix of its counts over
// the chunks (its table row, in place; 32 chunks a round, one a lane) and
// its total.
__global__ void tile_rmw_scan_kernel(int* __restrict__ table, int n_chunks,
                                     int n_owners, int* __restrict__ totals) {
  const int o = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= n_owners) return;  // warp-uniform
  int* row = table + (size_t)o * n_chunks;
  int run = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < n_chunks ? row[c] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(ALL_LANES, incl, d);
      if (lane >= d) incl += t;
    }
    if (c < n_chunks) row[c] = run + incl - v;
    run += __shfl_sync(ALL_LANES, incl, 31);
  }
  if (lane == 0) totals[o] = run;
}

// P7 pass 3: the owner lists' bases (block 0 writes them to bounds, with
// the total last) and every in-grid update, as (cell in the owner tile,
// value bits), at its place in its owner's list.
__global__ void __launch_bounds__(Own::BIN_BT)
tile_rmw_fill_kernel(const int32_t* __restrict__ xs,
                     const int32_t* __restrict__ ys,
                     const float* __restrict__ vs, int u, int W, int H,
                     int n_owners, const int* __restrict__ table,
                     const int* __restrict__ totals,
                     const uint16_t* __restrict__ ranks,
                     int* __restrict__ bounds, int* __restrict__ wbase,
                     int* __restrict__ win_owner,
                     int2* __restrict__ entries) {
  extern __shared__ int base[];  // n_owners
  __shared__ int warp_sums[32];
  constexpr int IPT = Own::BIN_IPT;
  const int per = (n_owners + Own::BIN_BT - 1) / Own::BIN_BT;
  const int o0 = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per && o0 + k < n_owners; ++k) sum += totals[o0 + k];
  int all;
  int run = block_exclusive_scan<Own::BIN_BT>(sum, warp_sums, all);
  for (int k = 0; k < per && o0 + k < n_owners; ++k) {
    base[o0 + k] = run;
    if (blockIdx.x == 0) bounds[o0 + k] = run;
    run += totals[o0 + k];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) bounds[n_owners] = all;
  if (blockIdx.x == 0) {
    // each owner's first window among all owners' windows, and each
    // window's owner
    constexpr int WIN = Own::CELLS * Own::OWN_IPT;
    int nwin = 0;
    for (int k = 0; k < per && o0 + k < n_owners; ++k)
      nwin += (totals[o0 + k] + WIN - 1) / WIN;
    int wall;
    int wrun = block_exclusive_scan<Own::BIN_BT>(nwin, warp_sums, wall);
    for (int k = 0; k < per && o0 + k < n_owners; ++k) {
      wbase[o0 + k] = wrun;
      for (int q = 0; q < (totals[o0 + k] + WIN - 1) / WIN; ++q)
        win_owner[wrun++] = o0 + k;
    }
    if (threadIdx.x == 0) wbase[n_owners] = wall;
  }
  __syncthreads();
  const int OH = (H + Own::OC - 1) / Own::OC;
  const int* col = table + blockIdx.x;  // this chunk's column
  const int first = blockIdx.x * Own::BIN_BT * IPT +
                    (threadIdx.x >> 5) * 32 * IPT + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = first + 32 * j;
    if (i >= u) break;
    const int x = xs[i], y = ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    const int o = x / Own::OR * OH + y / Own::OC;
    const int cell = x % Own::OR * Own::OC + y % Own::OC;
    entries[base[o] + col[(size_t)o * gridDim.x] + ranks[i]] =
        make_int2(cell, __float_as_int(vs[i]));
  }
}

// The run of n values from run[0], added to acc in order; loads a batch
// ahead of the dependent adds.
__device__ __forceinline__ float add_run(float acc, const float* run, int n) {
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = run[k + q];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = __fadd_rn(acc, v[q]);
  }
  for (; k < n; ++k) acc = __fadd_rn(acc, run[k]);
  return acc;
}

// P7 pass 4: block b sorts window b of all owners' windows (in owner
// order) by cell, stably, into `sorted` at the window's own positions, and
// writes each cell's run in it as meta[b][cell] = start | count << 16.
__global__ void __launch_bounds__(Own::CELLS, 2048 / Own::CELLS)
tile_rmw_sort_kernel(const int* __restrict__ bounds,
                     const int* __restrict__ wbase,
                     const int* __restrict__ win_owner, int n_owners,
                     const int2* __restrict__ entries,
                     float* __restrict__ sorted,
                     uint32_t* __restrict__ meta) {
  constexpr int BT = Own::CELLS, IPT = Own::OWN_IPT, WIN = BT * IPT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem);
  int* start = reinterpret_cast<int*>(hist + BT / 32 * hist_stride(BT));
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  if (b >= wbase[n_owners]) return;  // block-uniform
  const int o = win_owner[b];
  const int win = bounds[o] + (b - wbase[o]) * WIN;
  const int end = min(win + WIN, bounds[o + 1]);
  const int at = (threadIdx.x >> 5) * 32 * IPT + (threadIdx.x & 31);
  int key[IPT], rank[IPT];
  float val[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int idx = win + at + 32 * j;
    const int2 e = idx < end ? entries[idx] : make_int2(-1, 0);
    key[j] = e.x;
    val[j] = __int_as_float(e.y);
  }
  stable_rank<BT, IPT>(key, end - win, BT, hist, start, 1, rank);
  const int n = start[threadIdx.x];
  int total;
  const int s = block_exclusive_scan<BT>(n, warp_sums, total);
  meta[(size_t)b * BT + threadIdx.x] = (uint32_t)s | (uint32_t)n << 16;
  start[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    if (key[j] >= 0) sorted[win + start[key[j]] + rank[j]] = val[j];
}

// P7 pass 5: block o stages its owner's sorted windows in shared memory
// one at a time, in order; each thread adds its cell's runs with
// __fadd_rn, then writes the cell (zeros included).
__global__ void __launch_bounds__(Own::CELLS, 2048 / Own::CELLS)
tile_rmw_sum_kernel(const int* __restrict__ bounds,
                    const int* __restrict__ wbase,
                    const float* __restrict__ sorted,
                    const uint32_t* __restrict__ meta,
                    float* __restrict__ out, int W, int H) {
  constexpr int BT = Own::CELLS, WIN = BT * Own::OWN_IPT;
  __shared__ float buf[WIN];
  const int o = blockIdx.x, w0 = wbase[o], w1 = wbase[o + 1];
  const int last = bounds[o + 1];
  float acc = 0.f;
  for (int b = w0, win = bounds[o]; b < w1; ++b, win += WIN) {
    const uint32_t m = meta[(size_t)b * BT + threadIdx.x];
    __syncthreads();  // the previous window is summed
    for (int e = threadIdx.x; e < min(WIN, last - win); e += BT)
      buf[e] = sorted[win + e];
    __syncthreads();
    acc = add_run(acc, buf + (m & 0xffffu), (int)(m >> 16));
  }
  const int OH = (H + Own::OC - 1) / Own::OC;
  const int x = o / OH * Own::OR + threadIdx.x / Own::OC;
  const int y = o % OH * Own::OC + threadIdx.x % Own::OC;
  if (x < W && y < H) out[(size_t)x * H + y] = acc;
}

// P8, one cooperative launch, three passes a grid barrier apart: zero the
// grid (as int32 counts); a warp a segment (lanes l, l + 32, l + 64), one
// integer atomicAdd a hit; each count k becomes S_k in place. Four cells
// a thread in the first and last pass (cells a multiple of 4). int32
// arithmetic wraps, as XLA's does.
__global__ void __launch_bounds__(SEG_THREADS)
segment_rmw_kernel(const int32_t* __restrict__ x8s,
                   const int32_t* __restrict__ yls,
                   const int32_t* __restrict__ as,
                   const int32_t* __restrict__ bs, int n, float val,
                   float* __restrict__ out, int W, int H) {
  cg::grid_group grid = cg::this_grid();
  int4* quads = reinterpret_cast<int4*>(out);
  const size_t n_quads = (size_t)W * H / 4;
  const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t n_threads = (size_t)gridDim.x * blockDim.x;
  for (size_t e = tid; e < n_quads; e += n_threads)
    quads[e] = make_int4(0, 0, 0, 0);
  grid.sync();
  int* counts = reinterpret_cast<int*>(out);
  for (size_t seg = tid >> 5; seg < (size_t)n; seg += n_threads >> 5) {
    const unsigned x8 = x8s[seg], yl = yls[seg], a = as[seg], b = bs[seg];
    for (int l = threadIdx.x & 31; l < 96; l += 32) {
      const int r = (int)((unsigned)l * a + b) >> 10;  // floor(/ 1024)
      if (r < 0 || r >= TS) continue;
      const int x = (int)(x8 + (unsigned)r), y = (int)(yl + (unsigned)l);
      if (x >= 0 && x < W && y >= 0 && y < H)
        atomicAdd(counts + (size_t)x * H + y, 1);
    }
  }
  grid.sync();
  for (size_t e = tid; e < n_quads; e += n_threads) {
    const int4 k = quads[e];
    quads[e] = make_int4(__float_as_int(k_fold_sum(k.x, val)),
                         __float_as_int(k_fold_sum(k.y, val)),
                         __float_as_int(k_fold_sum(k.z, val)),
                         __float_as_int(k_fold_sum(k.w, val)));
  }
}

// -- P9: owners of sub-tiles, cells in registers ---------------------------
//
// Replaced: vpu_probe.py::make_kernel (:76), reps x n_pairs iterations of a
// mode's body, each one or two masked (64, 128) tile RMWs ("visits") of a
// VMEM-resident grid, in one grid step. Each cell's sum has to follow visit
// order; nothing orders the cells of different tiles, and a visit's tile
// (rt, lt) is always a multiple of (64, 128). So a block owns VO_ROWS x 128
// cells of one tile position, a cell a thread: each cell has one owner,
// whatever visit covers it. A thread loads its cell once, keeps the
// running sum in a register over every visit and repetition, and stores it
// once. The block finds its visits by filtering the visit sequence in
// chunks of VO_THREADS: each thread tests one visit (its tile, and the band
// [d_lo, d_lo + span] of the mask against the owner's rows, which a steep
// ray's band on the lanes always meets), and a block scan compacts the
// hits in order into a list in shared memory. One repetition's list is the
// same in every repetition, so a list of at most VO_CAP entries is filtered
// once and walked reps times; a longer one is filtered and walked a part
// at a time, every repetition. The walk is the kernel's cost: every thread
// of the block takes every entry, a few dozen instructions each (up to
// 8,192 cell tests a visit over its owners). The rate at which the card
// issues instructions bounds fullv; full and the ray modes wait on their
// words' loads from device memory. (A binning pass that builds ordered
// per-tile lists first, as P7 does, measured within 3% of this at the
// tool's 16,384 pairs and 1.6-3.1 times slower at 64 pairs, in four
// launches; PERF.md.)
//
// Modes. rmw and vec compute their words from the loop index; full reads a
// visit's two words from device memory at the walk (a broadcast load each);
// fullv keeps them in the list, staged in shared memory by the filter: the
// counterpart of the TPU's SMEM scalar prefetch against a VMEM block. The
// ray modes read the ray's six aux words at the walk and each thread
// recomputes the v8 prologue (ca * DR + cb * other, the dM test, d_end)
// for its own cell. A visit adds +-val (+1.0 in rmw) to the cells its
// mask lets through; the TPU's 0.0 adds to the rest of the tile are skipped
// (above).
constexpr int VO_ROWS = 8;                // rows of an owner
constexpr int VO_THREADS = VO_ROWS * TL;  // a cell a thread
constexpr int VO_OWNERS = VS / VO_ROWS;   // owners of a tile position
constexpr int VO_CAP = 4096;              // list entries (32 KB)

// Visit v of a repetition: its pair i, half h (first or second visit of the
// pair), word column j (i & (ray_w - 1) in the ray modes) and words (C, w2).
template <int MODE>
__device__ __forceinline__ void vpu_visit(const int32_t* __restrict__ w,
                                          int cols, int ray_w, int v, int& j,
                                          int& C, int& w2) {
  const int i = MODE == RAY1 ? v : v >> 1, h = MODE == RAY1 ? 0 : v & 1;
  j = MODE == RAY1 || MODE == RAY2 ? i & (ray_w - 1) : i;
  if constexpr (MODE == RMW) {
    // tile rows (i & 7) and ((i + 3) & 7), lanes [0, 128), no mask
    C = 0;
    w2 = ((i + 3 * h) & 7) << 19;
  } else if constexpr (MODE == VEC) {
    const int t = h ? ((i + 1) & 3) | ((((i >> 2) + 3) & 7) << 4)
                    : (i & 3) | (((i >> 2) & 7) << 4);
    C = (i + 7 * h) & 1023;
    w2 = (h ? 51 | (9 << 7) : 37 | (5 << 7)) | (t << 15);
  } else {
    C = w[(size_t)(2 * h) * cols + j];
    w2 = w[(size_t)(2 * h + 1) * cols + j];
  }
}

// Whether a visit (w2, column j) can write a cell of the owner of rows
// [s_lo, s_lo + VO_ROWS) of tile (tx, ty): never a cell outside its tile,
// nor (in the masked modes) a row outside its band (s - d_lo <= span,
// unsigned) unless the band lies on the lanes (a steep ray).
template <int MODE>
__device__ __forceinline__ bool vpu_hits(const int32_t* __restrict__ w,
                                         int cols, int j, int w2, int tx,
                                         int ty, int s_lo) {
  const int tile = w2 >> 15;
  if ((tile >> 4) != tx || (tile & 15) != ty) return false;
  if constexpr (MODE == RMW) return true;
  if constexpr (MODE == RAY1 || MODE == RAY2)
    if (w[4 * (size_t)cols + j] == 1) return true;
  const int span = w2 & 127, d_lo = (w2 >> 7) & 255;
  return d_lo < s_lo + VO_ROWS && d_lo + span >= s_lo;
}

// A visit's words as the walk takes them: (C, w2) and, in the ray modes,
// the ray's six aux words (steep, sgM, sgm, dM, dm, deg).
template <int MODE>
struct VisitWords {
  static constexpr int N = MODE == RAY1 || MODE == RAY2 ? 8 : 2;
  int w[N];
};

// List entry e's words: from the entry in fullv, from the loop index in
// rmw and vec, from device memory in full and the ray modes.
template <int MODE>
__device__ __forceinline__ VisitWords<MODE> vpu_words(
    const int32_t* __restrict__ w, int cols, int ray_w, int2 e) {
  VisitWords<MODE> vw;
  if constexpr (MODE == FULLV) {
    vw.w[0] = e.x;
    vw.w[1] = e.y;
  } else {
    int j;
    vpu_visit<MODE>(w, cols, ray_w, e.x, j, vw.w[0], vw.w[1]);
    if constexpr (VisitWords<MODE>::N == 8) {
#pragma unroll
      for (int q = 0; q < 6; ++q) vw.w[2 + q] = w[(size_t)(4 + q) * cols + j];
    }
  }
  return vw;
}

// A visit on the cell (s, l) of the tile at (rt, lt): acc plus +-val where
// the mask lets the cell through (vpu_probe.py emit(), or emit_r() after
// the ray prologue in the ray modes), acc elsewhere.
template <int MODE>
__device__ __forceinline__ float vpu_add(float acc, const VisitWords<MODE>& vw,
                                         int s, int l, int rt, int lt,
                                         float val) {
  if constexpr (MODE == RMW) return __fadd_rn(acc, 1.f);
  const int C = vw.w[0], w2 = vw.w[1];
  const unsigned span = w2 & 127, d_lo = (w2 >> 7) & 255;
  if constexpr (VisitWords<MODE>::N == 8) {
    const bool stp = vw.w[2] == 1;
    const int sgM = vw.w[3], sgm = vw.w[4], dM = max(vw.w[5], 1);
    const int dm = vw.w[6], deg = vw.w[7];
    const unsigned ca = (unsigned)sgM * (unsigned)dm;
    const unsigned cb = (0u - (unsigned)sgm) * (unsigned)dM;
    const unsigned dr = stp ? l : s, other = stp ? s : l;
    const int d_end = deg - (stp ? lt : rt);
    if (ca * dr + cb * other + (unsigned)C < (unsigned)dM &&
        dr - d_lo <= span)
      acc = __fadd_rn(acc, (int)dr == d_end ? val : -val);
  } else {
    const unsigned v = (unsigned)(3 * s + 5 * l) + (unsigned)C;
    if (v < 60000u && (unsigned)s - d_lo <= span)
      acc = __fadd_rn(acc, s == (C & 63) ? val : -val);
  }
  return acc;
}

// P9: reps x n_pairs iterations of the mode's body on the carried grid
// (W, H), in place; words (rows, cols) int32. Block b owns rows [s_lo,
// s_lo + VO_ROWS) of tile position b / VO_OWNERS (row-major over the
// ceil(W / 64) x ceil(H / 128) tile positions).
template <int MODE>
__global__ void __launch_bounds__(VO_THREADS, 2)
vpu_loop_kernel(const int32_t* __restrict__ words, int cols, int n_pairs,
                int reps, float val, float* __restrict__ g, int W, int H) {
  __shared__ int2 list[VO_CAP];  // visit v, or (C, w2) in fullv
  __shared__ int warp_sums[32];
  const int t = blockIdx.x / VO_OWNERS, TY = (H + TL - 1) / TL;
  const int s_lo = blockIdx.x % VO_OWNERS * VO_ROWS;
  const int tx = t / TY, ty = t % TY, rt = tx * VS, lt = ty * TL;
  if (rt + s_lo >= W) return;  // block-uniform: no row in the grid
  const int s = s_lo + threadIdx.x / TL, l = threadIdx.x % TL;
  const bool mine = rt + s < W && lt + l < H;
  float* cell = g + (size_t)(rt + s) * H + lt + l;
  float acc = mine ? *cell : 0.f;
  const int ray_w = min(n_pairs, RAY_W_MAX);
  const int n_visits = MODE == RAY1 ? n_pairs : 2 * n_pairs;
  for (int rep = 0, start = 0; rep < reps;) {
    // fill: the hits of visits [start, v0), in order, up to VO_CAP
    int n = 0, v0 = start;
    for (; v0 < n_visits; v0 += VO_THREADS) {
      const int v = v0 + threadIdx.x;
      int hit = 0;
      int2 e = make_int2(0, 0);
      if (v < n_visits) {
        int j, C, w2;
        vpu_visit<MODE>(words, cols, ray_w, v, j, C, w2);
        hit = vpu_hits<MODE>(words, cols, j, w2, tx, ty, s_lo);
        e = MODE == FULLV ? make_int2(C, w2) : make_int2(v, 0);
      }
      int total;
      const int at = block_exclusive_scan<VO_THREADS>(hit, warp_sums, total);
      if (n + total > VO_CAP) break;  // block-uniform: the next fill's
      if (hit) list[n + at] = e;
      n += total;
    }
    __syncthreads();  // the list is written
    // the whole repetition's list: walk it for every repetition left
    const bool whole = start == 0 && v0 >= n_visits;
    for (int r = whole ? reps : 1; r > 0; --r)
      for (int k = 0; k < n; ++k)
        acc = vpu_add<MODE>(acc, vpu_words<MODE>(words, cols, ray_w, list[k]),
                            s, l, rt, lt, val);
    if (whole) break;
    __syncthreads();  // the list is walked before the next fill
    if (v0 >= n_visits) {
      ++rep;
      start = 0;
    } else {
      start = v0;
    }
  }
  if (mine) *cell = acc;
}

int last_error() { return (int)cudaGetLastError(); }

// P2-P4's launch: a block for each (8, 128) tile position of a (W, H)
// grid; -1 for invalid arguments or more blocks than one launch takes.
long long tile_blocks(int n, int W, int H) {
  if (n < 0 || W <= 0 || H <= 0) return -1;
  const long long tiles = (long long)((W + TS - 1) / TS) * ((H + TL - 1) / TL);
  return tiles > 0x7fffffffLL ? -1 : tiles;
}

// P7's scratch layout for u updates on a (W, H) grid: the lists' entries
// (int2, u), the (owner, chunk) table, owner totals, list bounds and first
// windows (n_owners + 1 each), each window's owner (at most max_windows),
// the sorted windows (float, u), the windows' runs (uint32, a cell of each
// window) and the ranks (uint16, u).
struct TileRmwPlan {
  static constexpr int BT = Own::CELLS, WIN = BT * Own::OWN_IPT;
  int n_chunks, n_owners, max_windows;
  size_t table, totals, bounds, wbase, win_owner, sorted, meta, ranks, bytes;
  TileRmwPlan(int u, int W, int H) {
    const int chunk = Own::BIN_BT * Own::BIN_IPT;
    n_chunks = (u + chunk - 1) / chunk;
    n_owners = ((W + Own::OR - 1) / Own::OR) * ((H + Own::OC - 1) / Own::OC);
    max_windows = n_owners + (u + WIN - 1) / WIN;
    table = 8 * (size_t)u;  // the entries (int2) first
    totals = table + 4 * (size_t)n_chunks * n_owners;
    bounds = totals + 4 * (size_t)n_owners;
    wbase = bounds + 4 * ((size_t)n_owners + 1);
    win_owner = wbase + 4 * ((size_t)n_owners + 1);
    sorted = win_owner + 4 * (size_t)max_windows;
    meta = sorted + 4 * (size_t)u;
    ranks = meta + 4 * (size_t)max_windows * BT;
    bytes = ranks + 2 * (size_t)u;
  }
  size_t hist_bytes() const {  // tile_rmw_count_kernel's shared memory
    return 2 * (size_t)(Own::BIN_BT / 32) * hist_stride(n_owners);
  }
  static size_t sort_bytes() {  // tile_rmw_sort_kernel's shared memory
    return 2 * (size_t)(BT / 32) * hist_stride(BT) + 4 * BT;
  }
};

constexpr size_t MAX_SHARED = 232448;  // a block's limit on an H100
constexpr size_t DEFAULT_SHARED = 49152;  // without the attribute
constexpr int MAX_DEVICES = 64;  // devices the per-device caches hold

// The current device, or -1 when it cannot be read or lies past the
// per-device caches.
int current_device() {
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

// The current device's multiprocessor count (read once per device), or 0
// when it cannot be read.
int sm_count() {
  static int sms[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// Lets P7's count and sort kernels take more than the default shared
// memory, once per device (the attribute is the device's); returns the
// CUDA error of the first call that failed.
int tile_rmw_attributes() {
  static bool set[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (set[dev]) return 0;
  int rc = (int)cudaFuncSetAttribute(
      tile_rmw_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SHARED);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(
        tile_rmw_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TileRmwPlan::sort_bytes());
  set[dev] = rc == 0;
  return rc;
}

int tile_rmw_launch(const int32_t* xs, const int32_t* ys, const float* vs,
                    int u, float* out, int W, int H, unsigned char* scratch,
                    long long scratch_bytes, cudaStream_t st) {
  const TileRmwPlan plan(u, W, H);
  if (u < 0 || W <= 0 || H <= 0 || (long long)plan.bytes > scratch_bytes ||
      plan.hist_bytes() > MAX_SHARED ||
      4 * (size_t)plan.n_owners > DEFAULT_SHARED)
    return (int)cudaErrorInvalidValue;
  if (u == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)W * H, st);
  int rc = tile_rmw_attributes();
  if (rc != 0) return rc;
  int2* entries = reinterpret_cast<int2*>(scratch);
  int* table = reinterpret_cast<int*>(scratch + plan.table);
  int* totals = reinterpret_cast<int*>(scratch + plan.totals);
  int* bounds = reinterpret_cast<int*>(scratch + plan.bounds);
  int* wbase = reinterpret_cast<int*>(scratch + plan.wbase);
  int* win_owner = reinterpret_cast<int*>(scratch + plan.win_owner);
  float* sorted = reinterpret_cast<float*>(scratch + plan.sorted);
  uint32_t* meta = reinterpret_cast<uint32_t*>(scratch + plan.meta);
  uint16_t* ranks = reinterpret_cast<uint16_t*>(scratch + plan.ranks);
  tile_rmw_count_kernel<<<plan.n_chunks, Own::BIN_BT, plan.hist_bytes(),
                          st>>>(xs, ys, u, W, H, plan.n_owners, table, ranks);
  tile_rmw_scan_kernel<<<(plan.n_owners + 7) / 8, 256, 0, st>>>(
      table, plan.n_chunks, plan.n_owners, totals);
  tile_rmw_fill_kernel<<<plan.n_chunks, Own::BIN_BT,
                         4 * (size_t)plan.n_owners, st>>>(
      xs, ys, vs, u, W, H, plan.n_owners, table, totals, ranks, bounds,
      wbase, win_owner, entries);
  tile_rmw_sort_kernel<<<plan.max_windows, Own::CELLS,
                         TileRmwPlan::sort_bytes(), st>>>(
      bounds, wbase, win_owner, plan.n_owners, entries, sorted, meta);
  tile_rmw_sum_kernel<<<plan.n_owners, Own::CELLS, 0, st>>>(
      bounds, wbase, sorted, meta, out, W, H);
  return last_error();
}

}  // namespace

// P1-P4: inputs of n entries, output (W, H) float32, written whole. P1: a
// float4 a thread, W * H a multiple of 4 and out 16-byte aligned; P2-P4: a
// block for each (8, 128) tile position. Each entry point launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int slam_probe_smem_stream(const void* xs, int n, void* out, int W,
                                      int H, void* stream) {
  const long long cells = (long long)W * H;
  if (n < 0 || W <= 0 || H <= 0 || cells % 4 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (cells / 4 + P1_THREADS - 1) / P1_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  smem_stream_kernel<<<(int)blocks, P1_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xs, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_dynamic_store(const void* xs, int n, void* out,
                                        int W, int H, void* stream) {
  const long long tiles = tile_blocks(n, W, H);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  dynamic_store_kernel<<<(int)tiles, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_dynamic_lane_store(const void* xs, const void* ys,
                                             int n, void* out, int W, int H,
                                             void* stream) {
  const long long tiles = tile_blocks(n, W, H);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  dynamic_lane_store_kernel<<<(int)tiles, TILE_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_masked_tile(const void* xs, const void* ys, int n,
                                      float val, void* out, int W, int H,
                                      void* stream) {
  const long long tiles = tile_blocks(n, W, H);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  masked_tile_kernel<<<(int)tiles, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, n, val, (float*)out, W, H);
  return last_error();
}

// P5: out (1,) float32 = the in-order sum of xs (n,) float32; one warp.
extern "C" int slam_probe_scalar_sum(const void* xs, int n, void* out,
                                     void* stream) {
  scalar_sum_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)xs, n,
                                                        (float*)out);
  return last_error();
}

// P6: out (n,) float32 = val, out 4-byte aligned: a float4 a thread, as
// many 256-thread blocks as the body needs, at most sixteen an SM.
extern "C" int slam_probe_fill(void* out, long long n, float val,
                               void* stream) {
  if (n <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const size_t to_edge = ((16 - ((uintptr_t)out & 15)) & 15) / sizeof(float);
  const size_t head = to_edge < (size_t)n ? to_edge : (size_t)n;
  const size_t n4 = ((size_t)n - head) / 4;
  const size_t want = (n4 + FILL_THREADS - 1) / FILL_THREADS;
  const size_t cap = (size_t)sms * 16;
  const size_t blocks = want < 1 ? 1 : want < cap ? want : cap;
  fill_kernel<<<(int)blocks, FILL_THREADS, 0,
                (cudaStream_t)stream>>>((float*)out, head, n4, (size_t)n,
                                        val);
  return last_error();
}

// P7: the scratch bytes slam_probe_tile_rmw needs.
extern "C" long long slam_probe_tile_rmw_scratch(int u, int W, int H) {
  return (long long)TileRmwPlan(u, W, H).bytes;
}

// P7: u updates (xs, ys int32, vs float32) into out (W, H) float32, written
// whole; scratch of at least slam_probe_tile_rmw_scratch bytes. Five
// kernels on `stream` (one memset when u == 0).
extern "C" int slam_probe_tile_rmw(const void* xs, const void* ys,
                                   const void* vs, int u, void* out, int W,
                                   int H, void* scratch,
                                   long long scratch_bytes, void* stream) {
  return tile_rmw_launch((const int32_t*)xs, (const int32_t*)ys,
                         (const float*)vs, u, (float*)out, W, H,
                         (unsigned char*)scratch, scratch_bytes,
                         (cudaStream_t)stream);
}

// P8: n segments (x8, yl, a, b int32) into out (W, H) float32, W * H a
// multiple of 4: one cooperative launch of as many blocks as fit on the
// card at once, on `stream`.
extern "C" int slam_probe_segment_rmw(const void* x8, const void* yl,
                                      const void* a, const void* b, int n,
                                      float val, void* out, int W, int H,
                                      void* stream) {
  if (n < 0 || W <= 0 || H <= 0 || ((size_t)W * H) % 4)
    return (int)cudaErrorInvalidValue;
  static int co_resident[MAX_DEVICES] = {};  // blocks, per device
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (co_resident[dev] == 0) {
    int sms, per_sm;
    int rc = (int)cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segment_rmw_kernel, SEG_THREADS, 0);
    if (rc != 0) return rc;
    co_resident[dev] = sms * per_sm;
  }
  const int blocks = co_resident[dev];
  void* args[] = {&x8, &yl, &a, &b, &n, &val, &out, &W, &H};
  return (int)cudaLaunchCooperativeKernel((const void*)segment_rmw_kernel,
                                          blocks, SEG_THREADS, args, 0,
                                          (cudaStream_t)stream);
}

// P9: mode 0-5 (rmw, vec, full, fullv, ray1, ray2); words (rows, cols)
// int32 with rows >= 4 (>= 10 for the ray modes); grid (W, H) float32,
// updated in place. A block of VO_THREADS for each VO_ROWS x 128 owner of
// the ceil(W / 64) x ceil(H / 128) tile positions.
extern "C" int slam_probe_vpu_loop(const void* words, int cols, int n_pairs,
                                   int mode, int reps, float val, void* grid,
                                   int W, int H, void* stream) {
  if (n_pairs < 0 || reps < 0 || n_pairs > (1 << 29) || W < 0 || H < 0)
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0 || reps == 0 || W == 0 || H == 0) return 0;
  const long long blocks = (long long)((W + VS - 1) / VS) *
                           ((H + TL - 1) / TL) * VO_OWNERS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int32_t* w = (const int32_t*)words;
  float* g = (float*)grid;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
#define PROBE_VPU_CASE(M)                                                   \
  case M:                                                                   \
    vpu_loop_kernel<M><<<(int)blocks, VO_THREADS, 0, st>>>(                 \
        w, cols, n_pairs, reps, val, g, W, H);                              \
    break;
    PROBE_VPU_CASE(RMW)
    PROBE_VPU_CASE(VEC)
    PROBE_VPU_CASE(FULL)
    PROBE_VPU_CASE(FULLV)
    PROBE_VPU_CASE(RAY1)
    PROBE_VPU_CASE(RAY2)
#undef PROBE_VPU_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return last_error();
}
