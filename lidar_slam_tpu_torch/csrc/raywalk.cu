// raywalk_build: the whole log-odds map build (every scan, every ray) in
// one launch, exact against the scatter path.
//
// Replaces: lidar_slam_tpu/ops/raywalk.py::_make_kernel_v11 (launched by
// _build_fused from build_logodds_raywalk, the TPU default), and serves the
// domain of its fallbacks (_make_kernel_v8 with an init grid, and the v1
// kernel in raywalk_legacy.py for K > 704): this kernel takes an optional
// init grid and has no cap on K or the map size.
//
// Semantics (reference modules/ogm.py:149-188, models/occupancy.py): scans
// in order; within a scan, rays in order; each valid ray walks its
// in-bounds Bresenham slots [k_in, k_out] (tail-capped at K slots), adding
// -log4 to every cell and +log4 to the cell at k_out (the last in-bounds
// cell); after every scan the grid is clipped to +/-clip. Each cell receives
// its adds in ray order, so the float32 sums equal the scatter path's bit
// for bit. Only the closed-form slot interval of ray_descriptors
// (ops/raywalk.py) carries over from the TPU design; its packed visit words
// and SMEM page layouts were Mosaic encodings and are not used.
//
// What bounds it on an H100: the grid (1201 x 1201 float32 = 5.8 MB on the
// main path) cannot live in one SM's shared memory (227 KB), and a
// ray-parallel atomicAdd walk would lose the ray order the exactness needs.
// The work itself is small (~10^8 cell updates at dataset-20 scale); the
// cost is the per-ray interval test every block repeats, and the barrier
// after each ray that touches the block's tile.
//
// Design: thread blocks own map tiles. Block (bx, by) keeps the 64 x 64
// tile at x0 = 64 bx, y0 = 64 by in shared memory (16 KB), loaded once
// from the grid (zeros or an init grid). For each scan, it takes the rays
// 128 at a time: each thread computes one ray's slot interval clipped to
// the map (the closed form of ray_descriptors) and then to the tile (the
// same closed form with the tile's bounds); the rays with a non-empty
// sub-interval are compacted in order into shared memory. The block then
// walks them in order: thread t adds to the cell at slot k_lo + t (one ray
// never visits a cell twice, and a ray crosses a 64-cell tile in at most
// 64 slots), with a barrier between rays. After the scan the tile is
// clipped. Tiles never interact, so there is no grid-wide synchronisation,
// and the tile is written back once at the end.
//
// Integer division: the closed forms divide negative numerators, and JAX's
// '//' floors while C++ '/' truncates toward zero, so floordiv() is used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RW_TILE = 64;
constexpr int RW_THREADS = 128;
constexpr int RW_WARPS = RW_THREADS / 32;
constexpr int RW_BIG = 1 << 28;

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Ray {
  int steep, sM, sm, sgM, sgm, dM, dm, c;
};

__device__ __forceinline__ Ray ray_from_ends(int sx, int sy, int ex, int ey) {
  Ray r;
  const int dx0 = abs(ex - sx), dy0 = abs(ey - sy);
  r.steep = dy0 > dx0;
  r.dM = max(dx0, dy0);
  r.dm = min(dx0, dy0);
  r.c = r.dM > 0 ? r.dM - 1 - r.dM / 2 : 0;
  const int sgx = sx <= ex ? 1 : -1, sgy = sy <= ey ? 1 : -1;
  r.sgM = r.steep ? sgy : sgx;
  r.sgm = r.steep ? sgx : sgy;
  r.sM = r.steep ? sy : sx;
  r.sm = r.steep ? sx : sy;
  return r;
}

// The slot interval [klo, khi] of the ray's cells whose major coordinate
// lies in [loM, hiM] and minor coordinate in [lom, him] (ops/raywalk.py
// ray_descriptors with general bounds; the minor coordinate of slot k is
// sm + sgm * floor((k dm + c) / dM)).
__device__ __forceinline__ void interval(const Ray& r, int loM, int hiM,
                                         int lom, int him, int& klo,
                                         int& khi) {
  const int aM = r.sgM > 0 ? loM - r.sM : r.sM - hiM;
  const int bM = r.sgM > 0 ? hiM - r.sM : r.sM - loM;
  const int m_ub = r.sgm > 0 ? him - r.sm : r.sm - lom;
  const int m_lb = r.sgm > 0 ? lom - r.sm : r.sm - him;
  int k_ub, k_lb;
  if (r.dm > 0) {
    k_ub = floordiv((m_ub + 1) * r.dM - 1 - r.c, r.dm);
    k_lb = -floordiv(r.c - m_lb * r.dM, r.dm);
  } else {
    k_ub = m_ub >= 0 ? RW_BIG : -1;
    k_lb = m_lb <= 0 ? -RW_BIG : RW_BIG;
  }
  klo = max(max(0, aM), k_lb);
  khi = min(min(r.dM, bM), k_ub);
}

__global__ void __launch_bounds__(RW_THREADS)
raywalk_build_kernel(const int32_t* __restrict__ ends,
                     const uint8_t* __restrict__ mask, int S, int R, int W,
                     int H, int K, float log4, float clip,
                     float* __restrict__ grid) {
  __shared__ float tile[RW_TILE][RW_TILE];
  // compacted rays of the current batch that touch this tile, in ray order
  __shared__ int q_lo[RW_THREADS], q_hi[RW_THREADS], q_end[RW_THREADS];
  __shared__ int q_sM[RW_THREADS], q_sm[RW_THREADS], q_sg[RW_THREADS];
  __shared__ int q_dM[RW_THREADS], q_dm[RW_THREADS], q_c[RW_THREADS];
  __shared__ int warp_count[RW_WARPS];

  const int x0 = blockIdx.x * RW_TILE, y0 = blockIdx.y * RW_TILE;
  const int x1 = x0 + RW_TILE - 1, y1 = y0 + RW_TILE - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < RW_TILE * RW_TILE; e += RW_THREADS) {
    const int gx = x0 + e / RW_TILE, gy = y0 + e % RW_TILE;
    tile[e / RW_TILE][e % RW_TILE] =
        (gx < W && gy < H) ? grid[(size_t)gx * H + gy] : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    for (int base = 0; base < R; base += RW_THREADS) {
      // phase A: one ray per thread -> its sub-interval inside the tile
      const int r = base + tid;
      int klo = 1, khi = 0, kend = 0;
      Ray ray = {};
      if (r < R && mask[(size_t)s * R + r]) {
        const int32_t* e = ends + ((size_t)s * R + r) * 4;
        const int sx = e[0], sy = e[1], ex = e[2], ey = e[3];
        // the ray's cells lie in the bounding box of its two end cells
        if (max(sx, ex) >= x0 && min(sx, ex) <= x1 && max(sy, ey) >= y0 &&
            min(sy, ey) <= y1) {
          ray = ray_from_ends(sx, sy, ex, ey);
          int k_in, k_out;
          if (ray.steep) {
            interval(ray, 0, H - 1, 0, W - 1, k_in, k_out);
          } else {
            interval(ray, 0, W - 1, 0, H - 1, k_in, k_out);
          }
          k_out = min(k_out, K - 1);  // fixed-slot tail truncation
          if (k_in <= k_out) {
            int t_lo, t_hi;
            if (ray.steep) {
              interval(ray, y0, y1, x0, x1, t_lo, t_hi);
            } else {
              interval(ray, x0, x1, y0, y1, t_lo, t_hi);
            }
            klo = max(k_in, t_lo);
            khi = min(k_out, t_hi);
            kend = k_out;
          }
        }
      }
      const bool hit = klo <= khi;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int offset = __popc(ballot & ((1u << lane) - 1u)), total = 0;
      for (int w = 0; w < RW_WARPS; ++w) {
        if (w < warp) offset += warp_count[w];
        total += warp_count[w];
      }
      if (hit) {
        q_lo[offset] = klo;
        q_hi[offset] = khi;
        q_end[offset] = kend;
        q_sM[offset] = ray.sM;
        q_sm[offset] = ray.sm;
        // signs and steepness packed: bit 0 steep, bit 1 sgM < 0, bit 2 sgm < 0
        q_sg[offset] = ray.steep | (ray.sgM < 0) << 1 | (ray.sgm < 0) << 2;
        q_dM[offset] = max(ray.dM, 1);
        q_dm[offset] = ray.dm;
        q_c[offset] = ray.c;
      }
      __syncthreads();

      // phase B: walk the touching rays in order, one slot per thread
      for (int j = 0; j < total; ++j) {
        const int k = q_lo[j] + tid;
        if (k <= q_hi[j]) {
          const int sg = q_sg[j];
          const int sgM = (sg & 2) ? -1 : 1, sgm = (sg & 4) ? -1 : 1;
          const int major = q_sM[j] + sgM * k;
          const int minor = q_sm[j] + sgm * ((k * q_dm[j] + q_c[j]) / q_dM[j]);
          const int x = (sg & 1) ? minor : major;
          const int y = (sg & 1) ? major : minor;
          float& cell = tile[x - x0][y - y0];
          cell = __fadd_rn(cell, k == q_end[j] ? log4 : -log4);
        }
        __syncthreads();
      }
      if (total == 0) __syncthreads();  // q_* and warp_count reuse barrier
    }
    // per-scan clip (reference modules/ogm.py:188)
    for (int e = tid; e < RW_TILE * RW_TILE; e += RW_THREADS) {
      float& v = tile[e / RW_TILE][e % RW_TILE];
      v = fminf(fmaxf(v, -clip), clip);
    }
    __syncthreads();
  }

  for (int e = tid; e < RW_TILE * RW_TILE; e += RW_THREADS) {
    const int gx = x0 + e / RW_TILE, gy = y0 + e % RW_TILE;
    if (gx < W && gy < H) grid[(size_t)gx * H + gy] = tile[e / RW_TILE][e % RW_TILE];
  }
}

}  // namespace

// ends (S, R, 4) int32 rows (sx, sy, ex, ey) of ray start and end cells;
// mask (S, R) bool as bytes; grid (W, H) float32, read as the initial map
// and overwritten with the result. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int slam_raywalk_build(const void* ends, const void* mask, int S,
                                  int R, int W, int H, int K, float log4,
                                  float clip, void* grid, void* stream) {
  if (W <= 0 || H <= 0) return 0;
  if (S < 0 || R < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  dim3 blocks((W + RW_TILE - 1) / RW_TILE, (H + RW_TILE - 1) / RW_TILE);
  raywalk_build_kernel<<<blocks, RW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const uint8_t*)mask, S, R, W, H, K, log4, clip,
      (float*)grid);
  return (int)cudaGetLastError();
}
