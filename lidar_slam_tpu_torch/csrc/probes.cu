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
// Exactness without barriers or atomics. Every probe adds in a fixed order
// (update order, segment order or emit order). The TPU tiles are (8, 128)
// (P1-P4, P7, P8) or (64, 128) (P9), always at offsets that are multiples
// of the tile, so a cell has one tile-local position (s, l) whatever tile
// covers it. The thread that owns (s, l) does every add to the cells at
// that position, in order; no other thread touches them, so each cell's
// float32 sum is the sequential one. The TPU's masked RMW also adds 0.0 to
// the rest of the tile; x + 0.0 == x for every x except -0.0 and NaN, which
// no probe's grid holds (it starts at +0.0 or at finite random values, and
// a round-to-nearest sum of nonzero terms is never -0.0), so those adds
// are skipped. Cells outside the grid are dropped (the tools never
// produce them).
//
// What bounds them on an H100. P1-P5 move under 70 KB: one launch, a few
// microseconds. P6 writes the padded 1208 x 1216 grid (5.9 MB): bytes,
// about 1.8 us at 3.35 TB/s; the grid exceeds the 227 KB of shared memory
// a block can use and fits the 50 MB L2. P7 and P8 read their updates
// (12 or 16 B each) and write the grid once: bytes. P9 is one block on one
// SM by design (the TPU's grid=(1,)): it measures the serial cost of one
// masked (64, 128) tile RMW per visit, and its grid (512 x 512, 1 MB) stays
// in global memory, resident in L2.
//
// Designs. P1-P4: one block of 1,024 threads, one per (8, 128) position.
// P5: one thread. P6: a grid-stride fill. P7, P8: block b owns the grid's
// rows [8b, 8b + 8) (the TPU tile's row band), thread (s, l) the band's
// cells in row 8b + s whose column is l mod 128; the block reads the
// updates 1,024 at a time, compacts those that touch its band in order
// (a ballot and per-warp counts), and each owner
// applies its cells' adds in that order. P9: one block of 1,024 threads,
// eight positions of the (64, 128) tile each; the word table is read from
// device memory (one broadcast load per emit) or, in mode fullv, staged
// through shared memory: the counterpart of the TPU's SMEM scalar
// prefetch against a VMEM block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 8;      // rows of the (8, 128) tile
constexpr int TL = 128;    // lanes of a tile (both tile shapes)
constexpr int TILE_THREADS = TS * TL;  // one thread per (8, 128) position
constexpr int TILE_WARPS = TILE_THREADS / 32;

// P9's (64, 128) tile, eight positions a thread
constexpr int VS = 64;
constexpr int V_PER_THREAD = VS * TL / TILE_THREADS;
constexpr int V_STAGE = 2048;  // word columns staged per round in fullv
constexpr int RAY_W_MAX = 4096;

enum VpuMode { RMW = 0, VEC = 1, FULL = 2, FULLV = 3, RAY1 = 4, RAY2 = 5 };

__device__ __forceinline__ void add_cell(float* __restrict__ g, int W, int H,
                                         int x, int y, float v) {
  if (x >= 0 && x < W && y >= 0 && y < H) {
    float* p = g + (size_t)x * H + y;
    *p = __fadd_rn(*p, v);
  }
}

// P1-P4: thread (s, l) zeroes every cell it owns.
__device__ __forceinline__ void zero_owned(float* __restrict__ out, int W,
                                           int H, int s, int l) {
  for (int x = s; x < W; x += TS)
    for (int y = l; y < H; y += TL) out[(size_t)x * H + y] = 0.f;
}

// P1: the static tile [0, 8) x [0, 128) += xs[i], i in order.
__global__ void __launch_bounds__(TILE_THREADS)
smem_stream_kernel(const float* __restrict__ xs, int n,
                   float* __restrict__ out, int W, int H) {
  const int s = threadIdx.x / TL, l = threadIdx.x % TL;
  zero_owned(out, W, H, s, l);
  for (int i = 0; i < n; ++i) add_cell(out, W, H, s, l, xs[i]);
}

// P2: rows [x8, x8 + 8) x lanes [0, 128) += 1, x8 = floor(x / 8) * 8.
__global__ void __launch_bounds__(TILE_THREADS)
dynamic_store_kernel(const int32_t* __restrict__ xs, int n,
                     float* __restrict__ out, int W, int H) {
  const int s = threadIdx.x / TL, l = threadIdx.x % TL;
  zero_owned(out, W, H, s, l);
  for (int i = 0; i < n; ++i)
    add_cell(out, W, H, (xs[i] >> 3) * TS + s, l, 1.f);
}

// P3: as P2 at the 128-aligned lane offset yl = floor(y / 128) * 128.
__global__ void __launch_bounds__(TILE_THREADS)
dynamic_lane_store_kernel(const int32_t* __restrict__ xs,
                          const int32_t* __restrict__ ys, int n,
                          float* __restrict__ out, int W, int H) {
  const int s = threadIdx.x / TL, l = threadIdx.x % TL;
  zero_owned(out, W, H, s, l);
  for (int i = 0; i < n; ++i)
    add_cell(out, W, H, (xs[i] >> 3) * TS + s, (ys[i] >> 7) * TL + l, 1.f);
}

// P4: cell (x, y) += val: the one cell of the tile's mask.
__global__ void __launch_bounds__(TILE_THREADS)
masked_tile_kernel(const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys, int n, float val,
                   float* __restrict__ out, int W, int H) {
  const int s = threadIdx.x / TL, l = threadIdx.x % TL;
  zero_owned(out, W, H, s, l);
  for (int i = 0; i < n; ++i) {
    const int x = xs[i], y = ys[i];
    if ((x & (TS - 1)) == s && (y & (TL - 1)) == l)
      add_cell(out, W, H, x, y, val);
  }
}

// P5: the in-order float32 sum of xs.
__global__ void scalar_sum_kernel(const float* __restrict__ xs, int n,
                                  float* __restrict__ out) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, xs[i]);
  out[0] = acc;
}

// P6: every element = val.
__global__ void fill_kernel(float* __restrict__ out, size_t n, float val) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = val;
}

// The threads whose `hit` is set, numbered in thread order: returns this
// thread's slot among them and sets total (the same in every thread).
// Starts with a barrier after the warp counts are written.
__device__ __forceinline__ int compact_hits(bool hit, int* warp_count,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = __popc(ballot & ((1u << lane) - 1u));
  total = 0;
  for (int w = 0; w < TILE_WARPS; ++w) {
    if (w < warp) offset += warp_count[w];
    total += warp_count[w];
  }
  return offset;
}

// P7: out = 0, then out[x_i, y_i] += v_i for every update i in order.
__global__ void __launch_bounds__(TILE_THREADS)
tile_rmw_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                const float* __restrict__ vs, int u, float* __restrict__ out,
                int W, int H) {
  __shared__ int qx[TILE_THREADS], qy[TILE_THREADS];
  __shared__ float qv[TILE_THREADS];
  __shared__ int warp_count[TILE_WARPS];
  const int band = blockIdx.x, s = threadIdx.x / TL, l = threadIdx.x % TL;
  const int row = band * TS + s;
  if (row < W)
    for (int y = l; y < H; y += TL) out[(size_t)row * H + y] = 0.f;
  for (int base = 0; base < u; base += TILE_THREADS) {
    const int j = base + threadIdx.x;
    int x = -1, y = 0;
    float v = 0.f;
    if (j < u) {
      x = xs[j];
      y = ys[j];
      v = vs[j];
    }
    const bool hit = x >= 0 && x < W && y >= 0 && y < H && (x >> 3) == band;
    int total;
    const int at = compact_hits(hit, warp_count, total);
    if (hit) {
      qx[at] = x;
      qy[at] = y;
      qv[at] = v;
    }
    __syncthreads();
    for (int k = 0; k < total; ++k)
      if (qx[k] == row && (qy[k] & (TL - 1)) == l)
        add_cell(out, W, H, row, qy[k], qv[k]);
    __syncthreads();  // the queue is refilled next
  }
}

// P8: out = 0, then per segment (x8, yl, a, b), in order: the cells
// (x8 + s, yl + l) with s == floor((l a + b) / 1024) and l < 96 += val.
// int32 arithmetic wraps, as XLA's does.
__global__ void __launch_bounds__(TILE_THREADS)
segment_rmw_kernel(const int32_t* __restrict__ x8s,
                   const int32_t* __restrict__ yls,
                   const int32_t* __restrict__ as,
                   const int32_t* __restrict__ bs, int n, float val,
                   float* __restrict__ out, int W, int H) {
  __shared__ int qx[TILE_THREADS], qy[TILE_THREADS], qa[TILE_THREADS],
      qb[TILE_THREADS];
  __shared__ int warp_count[TILE_WARPS];
  const int band = blockIdx.x, p = threadIdx.x % TL;
  const int row = band * TS + threadIdx.x / TL;
  if (row < W)
    for (int y = p; y < H; y += TL) out[(size_t)row * H + y] = 0.f;
  for (int base = 0; base < n; base += TILE_THREADS) {
    const int j = base + threadIdx.x;
    bool hit = false;
    int x8 = 0, yl = 0, a = 0, b = 0;
    if (j < n) {
      x8 = x8s[j];
      yl = yls[j];
      a = as[j];
      b = bs[j];
      // rows [x8, x8 + 8) meet the band [8 band, 8 band + 8)
      hit = x8 <= band * TS + TS - 1 && x8 >= band * TS - TS + 1;
    }
    int total;
    const int at = compact_hits(hit, warp_count, total);
    if (hit) {
      qx[at] = x8;
      qy[at] = yl;
      qa[at] = a;
      qb[at] = b;
    }
    __syncthreads();
    for (int k = 0; k < total; ++k) {
      const int s = row - qx[k];
      if (s < 0 || s >= TS) continue;
      // the one column of [yl, yl + 128) that is p mod 128
      const int l = (p - qy[k]) & (TL - 1);
      const int r =
          (int)((unsigned)l * (unsigned)qa[k] + (unsigned)qb[k]) >> 10;
      if (r == s && l < 96) add_cell(out, W, H, row, qy[k] + l, val);
    }
    __syncthreads();
  }
}

// P9 emit() of the pair modes (vpu_probe.py emit): unpack the word pair,
// test tile membership of each owned cell, add +-val to the members.
__device__ __forceinline__ void emit_pair(float* __restrict__ g, int W, int H,
                                          int s0, int l, int C, int w2,
                                          float val) {
  const unsigned span = w2 & 127, d_lo = (w2 >> 7) & 255;
  const int tile = w2 >> 15;
  const int lt = (tile & 15) * TL, rt = (tile >> 4) * VS, d_end = C & 63;
#pragma unroll
  for (int k = 0; k < V_PER_THREAD; ++k) {
    const int s = s0 + k * TS;
    const unsigned v = (unsigned)(3 * s + 5 * l) + (unsigned)C;
    if (v < 60000u && (unsigned)s - d_lo <= span)
      add_cell(g, W, H, rt + s, lt + l, s == d_end ? val : -val);
  }
}

// P9 ray modes: the v8 ray prologue (six aux words, DR and V0 per cell)
// and emit_r(), with the end row taken from the ray's deg word.
struct RayCells {
  int stp, deg;
  unsigned dM;
  unsigned v0[V_PER_THREAD];
};

__device__ __forceinline__ RayCells ray_prologue(const int32_t* __restrict__ w,
                                                 int cols, int i, int s0,
                                                 int l) {
  RayCells r;
  r.stp = w[4 * cols + i] == 1;
  const int sgM = w[5 * cols + i], sgm = w[6 * cols + i];
  const int dM = max(w[7 * cols + i], 1), dm = w[8 * cols + i];
  r.deg = w[9 * cols + i];
  r.dM = (unsigned)dM;
  const unsigned ca = (unsigned)sgM * (unsigned)dm;
  const unsigned cb = (0u - (unsigned)sgm) * (unsigned)dM;
#pragma unroll
  for (int k = 0; k < V_PER_THREAD; ++k) {
    const int s = s0 + k * TS;
    const unsigned dr = r.stp ? l : s, other = r.stp ? s : l;
    r.v0[k] = ca * dr + cb * other;
  }
  return r;
}

__device__ __forceinline__ void emit_ray(float* __restrict__ g, int W, int H,
                                         int s0, int l, const RayCells& r,
                                         int C, int w2, float val) {
  const unsigned span = w2 & 127, d_lo = (w2 >> 7) & 255;
  const int tile = w2 >> 15;
  const int lt = (tile & 15) * TL, rt = (tile >> 4) * VS;
  const int d_end = r.deg - (r.stp ? lt : rt);
#pragma unroll
  for (int k = 0; k < V_PER_THREAD; ++k) {
    const int s = s0 + k * TS;
    const int dr = r.stp ? l : s;
    if (r.v0[k] + (unsigned)C < r.dM && (unsigned)dr - d_lo <= span)
      add_cell(g, W, H, rt + s, lt + l, dr == d_end ? val : -val);
  }
}

// P9: reps x n_pairs iterations of the mode's body on the carried grid
// (W, H), in place; words (rows, cols) int32.
template <int MODE>
__global__ void __launch_bounds__(TILE_THREADS)
vpu_loop_kernel(const int32_t* __restrict__ words, int cols, int n_pairs,
                int reps, float val, float* __restrict__ g, int W, int H) {
  __shared__ int stage[4][V_STAGE];  // fullv only (32 KB)
  const int s0 = threadIdx.x / TL, l = threadIdx.x % TL;
  const int ray_w = min(n_pairs, RAY_W_MAX);
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (MODE == FULLV) {
      for (int base = 0; base < n_pairs; base += V_STAGE) {
        const int m = min(V_STAGE, n_pairs - base);
        __syncthreads();  // the previous round is consumed
        for (int e = threadIdx.x; e < 4 * m; e += TILE_THREADS)
          stage[e / m][e % m] = words[(size_t)(e / m) * cols + base + e % m];
        __syncthreads();
        for (int i = 0; i < m; ++i) {
          emit_pair(g, W, H, s0, l, stage[0][i], stage[1][i], val);
          emit_pair(g, W, H, s0, l, stage[2][i], stage[3][i], val);
        }
      }
    } else {
      for (int i = 0; i < n_pairs; ++i) {
        if constexpr (MODE == RMW) {
          // two alternating-tile RMWs at lanes [0, 128), no mask
          const int rt = (i & 7) * VS, rt2 = ((i + 3) & 7) * VS;
#pragma unroll
          for (int k = 0; k < V_PER_THREAD; ++k)
            add_cell(g, W, H, rt + s0 + k * TS, l, 1.f);
#pragma unroll
          for (int k = 0; k < V_PER_THREAD; ++k)
            add_cell(g, W, H, rt2 + s0 + k * TS, l, 1.f);
        } else if constexpr (MODE == VEC) {
          const int t1 = (i & 3) | (((i >> 2) & 7) << 4);
          const int t2 = ((i + 1) & 3) | ((((i >> 2) + 3) & 7) << 4);
          emit_pair(g, W, H, s0, l, i & 1023, 37 | (5 << 7) | (t1 << 15), val);
          emit_pair(g, W, H, s0, l, (i + 7) & 1023, 51 | (9 << 7) | (t2 << 15),
                    val);
        } else if constexpr (MODE == FULL) {
          emit_pair(g, W, H, s0, l, words[i], words[cols + i], val);
          emit_pair(g, W, H, s0, l, words[2 * cols + i], words[3 * cols + i],
                    val);
        } else {  // RAY1, RAY2
          const int j = i & (ray_w - 1);
          const RayCells r = ray_prologue(words, cols, j, s0, l);
          emit_ray(g, W, H, s0, l, r, words[j], words[cols + j], val);
          if constexpr (MODE == RAY2)
            emit_ray(g, W, H, s0, l, r, words[2 * cols + j],
                     words[3 * cols + j], val);
        }
      }
    }
  }
}

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

// P1-P4: inputs of n entries, output (W, H) float32, written whole. One
// block. Each entry point launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int slam_probe_smem_stream(const void* xs, int n, void* out, int W,
                                      int H, void* stream) {
  smem_stream_kernel<<<1, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xs, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_dynamic_store(const void* xs, int n, void* out,
                                        int W, int H, void* stream) {
  dynamic_store_kernel<<<1, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_dynamic_lane_store(const void* xs, const void* ys,
                                             int n, void* out, int W, int H,
                                             void* stream) {
  dynamic_lane_store_kernel<<<1, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, n, (float*)out, W, H);
  return last_error();
}

extern "C" int slam_probe_masked_tile(const void* xs, const void* ys, int n,
                                      float val, void* out, int W, int H,
                                      void* stream) {
  masked_tile_kernel<<<1, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, n, val, (float*)out, W, H);
  return last_error();
}

// P5: out (1,) float32 = the in-order sum of xs (n,) float32.
extern "C" int slam_probe_scalar_sum(const void* xs, int n, void* out,
                                     void* stream) {
  scalar_sum_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const float*)xs, n,
                                                       (float*)out);
  return last_error();
}

// P6: out (n,) float32 = val.
extern "C" int slam_probe_fill(void* out, long long n, float val,
                               void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  fill_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0,
                (cudaStream_t)stream>>>((float*)out, (size_t)n, val);
  return last_error();
}

// P7: u updates (xs, ys int32, vs float32) into out (W, H) float32.
extern "C" int slam_probe_tile_rmw(const void* xs, const void* ys,
                                   const void* vs, int u, void* out, int W,
                                   int H, void* stream) {
  if (W <= 0 || H <= 0) return 0;
  tile_rmw_kernel<<<(W + TS - 1) / TS, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, (const float*)vs, u, (float*)out,
      W, H);
  return last_error();
}

// P8: n segments (x8, yl, a, b int32) into out (W, H) float32.
extern "C" int slam_probe_segment_rmw(const void* x8, const void* yl,
                                      const void* a, const void* b, int n,
                                      float val, void* out, int W, int H,
                                      void* stream) {
  if (W <= 0 || H <= 0) return 0;
  segment_rmw_kernel<<<(W + TS - 1) / TS, TILE_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)x8, (const int32_t*)yl, (const int32_t*)a,
      (const int32_t*)b, n, val, (float*)out, W, H);
  return last_error();
}

// P9: mode 0-5 (rmw, vec, full, fullv, ray1, ray2); words (rows, cols)
// int32 with rows >= 4 (>= 10 for the ray modes); grid (W, H) float32,
// updated in place. One block.
extern "C" int slam_probe_vpu_loop(const void* words, int cols, int n_pairs,
                                   int mode, int reps, float val, void* grid,
                                   int W, int H, void* stream) {
  if (n_pairs < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (n_pairs == 0 || reps == 0) return 0;
  const int32_t* w = (const int32_t*)words;
  float* g = (float*)grid;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
#define PROBE_VPU_CASE(M)                                                  \
  case M:                                                                  \
    vpu_loop_kernel<M><<<1, TILE_THREADS, 0, st>>>(w, cols, n_pairs, reps, \
                                                   val, g, W, H);          \
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
