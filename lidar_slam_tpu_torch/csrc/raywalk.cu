// Two ray-walk kernels of the log-odds map, exact against the scatter path:
//
// raywalk_build: the whole map build (every scan, every ray) in one launch.
// Replaces lidar_slam_tpu/ops/raywalk.py::_make_kernel_v11 (launched by
// _build_fused from build_logodds_raywalk, the TPU default), and serves the
// domain of the v1 kernel in raywalk_legacy.py for K > 704: it takes an
// optional init grid and has no cap on K or the map size.
//
// raywalk_scan: one scan's walk on a carried grid, in place, with an
// optional clip of the whole grid afterwards. Replaces
// lidar_slam_tpu/ops/raywalk.py::_make_kernel_v8 (launched by _make_call
// with the grid aliased in and out: build_logodds_raywalk with an init
// grid, and scan_delta_raywalk with no clip). It is the online mode's
// per-step map update. Per step at the online path's shapes (1,081 rays,
// K = 608, a 1201 x 1201 grid) it does about 1,081 x 1,444 interval tests
// and at most about 0.66 M cell updates; with the clip it also reads and
// writes the 5.8 MB grid once, a few microseconds of HBM traffic at 3.35
// TB/s. What bounds it is neither: every ray starts in the robot's cell,
// so whoever owns the robot's cell walks nearly every ray of the scan, in
// ray order, and the robot's cell alone takes about 1,081 dependent adds.
//
// Semantics (reference modules/ogm.py:149-188, models/occupancy.py): scans
// in order; within a scan, rays in order; each valid ray walks its
// in-bounds Bresenham slots [k_in, k_out] (tail-capped at K slots), adding
// -log4 to every cell and +log4 to the cell at k_out (the last in-bounds
// cell); after every scan the grid is clipped to +/-clip (raywalk_scan: once,
// and only when asked). Each cell receives
// its adds in ray order, so the float32 sums equal the scatter path's bit
// for bit. Only the closed-form slot interval of ray_descriptors
// (ops/raywalk.py) carries over from the TPU design; its packed visit words
// and SMEM page layouts were Mosaic encodings and are not used.
//
// What bounds raywalk_build on an H100: the grid (1201 x 1201 float32 = 5.8 MB on the
// main path) cannot live in one SM's shared memory (227 KB), and a
// ray-parallel atomicAdd walk would lose the ray order the exactness needs.
// The work itself is small (~10^8 cell updates at dataset-20 scale); the
// cost is the per-ray interval test every block repeats, and the barrier
// after each ray that touches the block's tile.
//
// Design of raywalk_build: thread blocks own map tiles. Block (bx, by)
// keeps the 64 x 64 tile at x0 = 64 bx, y0 = 64 by in shared memory (16
// KB), loaded once from the grid (zeros or an init grid). For each scan,
// it takes the rays 128 at a time: each thread computes one ray's slot
// interval clipped to the map (the closed form of ray_descriptors) and
// then to the tile (the same closed form with the tile's bounds); the rays
// with a non-empty sub-interval are compacted in order into shared memory.
// The block then walks them in order: thread t adds to the cell at slot
// k_lo + t (one ray never visits a cell twice, and a ray crosses a 64-cell
// tile in at most 64 slots), with a barrier between rays. After the scan
// the tile is clipped. Tiles never interact, so there is no grid-wide
// synchronisation, and the tile is written back once at the end.
//
// Design of raywalk_scan: a warp owns a 32 x 32 sub-tile. A block of
// four warps holds a 64 x 64 square, a quadrant a warp, and shares
// nothing else: the kernel has no block barrier and no shared-memory
// queue. The warp takes the scan's rays 32 at a time, lane l ray base + l
// (fetched a batch ahead), tests it against the map and then its sub-tile
// with the same closed forms, and ballots. Each lane whose ray touches
// the sub-tile precomputes the ray's walk through it in three words (its
// first cell, the major and minor steps, a 31-bit mask of where the
// minor coordinate steps, the slot count and the last in-map slot), and
// a shuffle gives lane j the payload of the j-th such ray. The warp then
// walks those rays in order: lane l takes slot lo + l (a ray crosses a
// 32-wide sub-tile in at most 32 slots, and never visits a cell twice),
// reads ray j's payload from lane j by __shfl_sync, finds its cell (a
// popcount of the mask) and adds to it, with __syncwarp() between rays so
// that each cell gets its adds in ray order; ray j + 1's cell is computed
// while ray j's read-add-write is in flight. Rows of the sub-tile are
// padded to 33 floats, so rays along either axis touch 32 distinct banks.
// With the clip every warp loads, clips and stores its sub-tile; without
// it a warp loads its sub-tile when the first ray that touches it
// arrives, and a warp that no ray touches reads and writes nothing.
//
// What bounds raywalk_scan on an H100: the robot's warp. Every ray of the
// scan crosses its sub-tile, and for each the warp runs a dependent chain
// on one scheduler: the ray's tests and walk layout (six integer
// divisions, spread over the lanes), its broadcast, and a shared-memory
// read-add-write one __syncwarp apart. The robot's cell alone takes one
// in-order add from every ray. It replaces a design in which a block of
// 128 threads owned a 64 x 64 tile, compacted the rays through a
// shared-memory queue and walked them one block barrier apart, with at
// most half its threads holding a slot (0.174 ms a clipped scan, PERF.md).
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

// One ray's slot sub-interval [klo, khi] inside the box [x0, x1] x [y0,
// y1] (empty when klo > khi), its last in-map slot kend and its Bresenham
// walk: the slot interval clipped to the map (the closed form of
// ray_descriptors, tail-capped at K) and then to the box. valid: the ray's
// mask bit.
__device__ __forceinline__ void clip_ray(int sx, int sy, int ex, int ey,
                                         bool valid, int W, int H, int K,
                                         int x0, int y0, int x1, int y1,
                                         Ray& ray, int& klo, int& khi,
                                         int& kend) {
  klo = 1;
  khi = 0;
  kend = 0;
  ray = {};
  // the ray's cells lie in the bounding box of its two end cells
  if (!valid || max(sx, ex) < x0 || min(sx, ex) > x1 || max(sy, ey) < y0 ||
      min(sy, ey) > y1) {
    return;
  }
  ray = ray_from_ends(sx, sy, ex, ey);
  // both closed forms at once (their divisions overlap)
  int k_in, k_out, t_lo, t_hi;
  if (ray.steep) {
    interval(ray, 0, H - 1, 0, W - 1, k_in, k_out);
    interval(ray, y0, y1, x0, x1, t_lo, t_hi);
  } else {
    interval(ray, 0, W - 1, 0, H - 1, k_in, k_out);
    interval(ray, x0, x1, y0, y1, t_lo, t_hi);
  }
  k_out = min(k_out, K - 1);  // fixed-slot tail truncation
  if (k_in > k_out) return;
  klo = max(k_in, t_lo);
  khi = min(k_out, t_hi);
  kend = k_out;
}

// The rays of one batch (RW_THREADS consecutive rays of a scan) that touch
// the block's tile, compacted in ray order: each one's slot sub-interval
// [lo, hi] inside the tile, its last in-map slot and its Bresenham walk.
struct RayQueue {
  int lo[RW_THREADS], hi[RW_THREADS], end[RW_THREADS];
  int sM[RW_THREADS], sm[RW_THREADS], sg[RW_THREADS];
  int dM[RW_THREADS], dm[RW_THREADS], c[RW_THREADS];
  int warp_count[RW_WARPS];
};

// Phase A: thread t takes ray base + t of the scan (ends (R, 4), mask (R,)),
// computes its slot interval clipped to the map (the closed form of
// ray_descriptors, tail-capped at K) and then to the tile at (x0, y0); the
// rays with a non-empty sub-interval are compacted in order into q. Returns
// their count, the same in every thread. Ends with a barrier.
__device__ __forceinline__ int compact_rays(const int32_t* __restrict__ ends,
                                            const uint8_t* __restrict__ mask,
                                            int base, int R, int W, int H,
                                            int K, int x0, int y0,
                                            RayQueue& q) {
  const int x1 = x0 + RW_TILE - 1, y1 = y0 + RW_TILE - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = base + tid;
  const bool valid = r < R && mask[r];
  int sx = 0, sy = 0, ex = 0, ey = 0;
  if (valid) {
    const int32_t* e = ends + (size_t)r * 4;
    sx = e[0];
    sy = e[1];
    ex = e[2];
    ey = e[3];
  }
  Ray ray;
  int klo, khi, kend;
  clip_ray(sx, sy, ex, ey, valid, W, H, K, x0, y0, x1, y1, ray, klo, khi,
           kend);
  const bool hit = klo <= khi;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) q.warp_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = __popc(ballot & ((1u << lane) - 1u)), total = 0;
  for (int w = 0; w < RW_WARPS; ++w) {
    if (w < warp) offset += q.warp_count[w];
    total += q.warp_count[w];
  }
  if (hit) {
    q.lo[offset] = klo;
    q.hi[offset] = khi;
    q.end[offset] = kend;
    q.sM[offset] = ray.sM;
    q.sm[offset] = ray.sm;
    // signs and steepness packed: bit 0 steep, bit 1 sgM < 0, bit 2 sgm < 0
    q.sg[offset] = ray.steep | (ray.sgM < 0) << 1 | (ray.sgm < 0) << 2;
    q.dM[offset] = max(ray.dM, 1);
    q.dm[offset] = ray.dm;
    q.c[offset] = ray.c;
  }
  __syncthreads();
  return total;
}

// Phase B: walk the `total` compacted rays in order, one slot per thread,
// adding -log4 to each cell and +log4 to the cell at the ray's last in-map
// slot. Ends with a barrier, so q may be refilled next.
__device__ __forceinline__ void walk_rays(int total, const RayQueue& q,
                                          float (*tile)[RW_TILE], int x0,
                                          int y0, float log4) {
  const int tid = threadIdx.x;
  for (int j = 0; j < total; ++j) {
    const int k = q.lo[j] + tid;
    if (k <= q.hi[j]) {
      const int sg = q.sg[j];
      const int sgM = (sg & 2) ? -1 : 1, sgm = (sg & 4) ? -1 : 1;
      const int major = q.sM[j] + sgM * k;
      const int minor = q.sm[j] + sgm * ((k * q.dm[j] + q.c[j]) / q.dM[j]);
      const int x = (sg & 1) ? minor : major;
      const int y = (sg & 1) ? major : minor;
      float& cell = tile[x - x0][y - y0];
      cell = __fadd_rn(cell, k == q.end[j] ? log4 : -log4);
    }
    __syncthreads();
  }
  if (total == 0) __syncthreads();  // q and warp_count reuse barrier
}

// Copy the block's tile in from the grid (zeros past the map's edge).
__device__ __forceinline__ void load_tile(const float* __restrict__ grid,
                                          int W, int H, int x0, int y0,
                                          float (*tile)[RW_TILE]) {
  for (int e = threadIdx.x; e < RW_TILE * RW_TILE; e += RW_THREADS) {
    const int gx = x0 + e / RW_TILE, gy = y0 + e % RW_TILE;
    tile[e / RW_TILE][e % RW_TILE] =
        (gx < W && gy < H) ? grid[(size_t)gx * H + gy] : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RW_THREADS)
raywalk_build_kernel(const int32_t* __restrict__ ends,
                     const uint8_t* __restrict__ mask, int S, int R, int W,
                     int H, int K, float log4, float clip,
                     float* __restrict__ grid) {
  __shared__ float tile[RW_TILE][RW_TILE];
  __shared__ RayQueue q;
  const int x0 = blockIdx.x * RW_TILE, y0 = blockIdx.y * RW_TILE;
  load_tile(grid, W, H, x0, y0, tile);

  for (int s = 0; s < S; ++s) {
    const int32_t* ends_s = ends + (size_t)s * R * 4;
    const uint8_t* mask_s = mask + (size_t)s * R;
    for (int base = 0; base < R; base += RW_THREADS) {
      const int total = compact_rays(ends_s, mask_s, base, R, W, H, K, x0,
                                     y0, q);
      walk_rays(total, q, tile, x0, y0, log4);
    }
    // per-scan clip (reference modules/ogm.py:188)
    for (int e = threadIdx.x; e < RW_TILE * RW_TILE; e += RW_THREADS) {
      float& v = tile[e / RW_TILE][e % RW_TILE];
      v = fminf(fmaxf(v, -clip), clip);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < RW_TILE * RW_TILE; e += RW_THREADS) {
    const int gx = x0 + e / RW_TILE, gy = y0 + e % RW_TILE;
    if (gx < W && gy < H) grid[(size_t)gx * H + gy] = tile[e / RW_TILE][e % RW_TILE];
  }
}

constexpr int RS_SUB = 32;               // a warp's sub-tile side
constexpr int RS_PITCH = RS_SUB + 1;     // padded row of the sub-tile
constexpr int RS_WARPS = 4;              // 2 x 2 sub-tiles a block
constexpr int RS_THREADS = 32 * RS_WARPS;
constexpr unsigned RS_ALL = 0xffffffffu;

// Copy the warp's sub-tile in from the grid (zeros past the map's edge):
// lane l takes column y0 + l of every row.
__device__ __forceinline__ void load_sub(const float* __restrict__ grid,
                                         int W, int H, int x0, int y0,
                                         float* tile) {
  const int lane = threadIdx.x & 31, gy = y0 + lane;
#pragma unroll 8
  for (int i = 0; i < RS_SUB; ++i) {
    const int gx = x0 + i;
    tile[i * RS_PITCH + lane] =
        (gx < W && gy < H) ? grid[(size_t)gx * H + gy] : 0.f;
  }
  __syncwarp();
}

// A ray's walk through the warp's sub-tile, as the lane that tested it
// precomputes it for the broadcast. Slot lo + l lies at sub-tile offset
// base + step_major * l + step_minor * m(l), where m(l), the minor
// coordinate's steps after slot lo, is the count of set bits of `steps`
// below bit l: bit l is set when the Bresenham walk's minor coordinate
// steps between slots lo + l and lo + l + 1 (by at most one, as dm <= dM).
struct SubRay {
  int key;         // base | (last in-map slot - lo) << 16 | slot count << 24
  unsigned steps;  // bit l: the minor coordinate steps after slot lo + l
  int step;        // step_major (low 16 bits) | step_minor << 16
};

__device__ __forceinline__ SubRay sub_ray(const Ray& r, int lo, int hi,
                                          int end, int x0, int y0) {
  const int dM = max(r.dM, 1);
  const int num = lo * r.dm + r.c;
  const int q = num / dM;
  const int rem = num - q * dM;  // (lo dm + c) mod dM
  // the 31 step bits as four independent chains of the Bresenham error,
  // each started 8 slots on
  const int e8 = (8 * r.dm) % dM;
  int start = rem;
  unsigned steps = 0;
#pragma unroll
  for (int part = 0; part < 4; ++part) {
    int err = start;
    start += e8;
    if (start >= dM) start -= dM;
#pragma unroll
    for (int l = part * 8; l < min(part * 8 + 8, RS_SUB - 1); ++l) {
      err += r.dm;
      if (err >= dM) {
        err -= dM;
        steps |= 1u << l;
      }
    }
  }
  const int major = r.sM + r.sgM * lo, minor = r.sm + r.sgm * q;
  const int x = r.steep ? minor : major, y = r.steep ? major : minor;
  SubRay w;
  // the last in-map slot's offset is capped at 32 (past the sub-tile)
  w.key = ((x - x0) * RS_PITCH + (y - y0)) | min(end - lo, RS_SUB) << 16 |
          (hi - lo + 1) << 24;
  w.steps = steps;
  const int step_major = (r.steep ? 1 : RS_PITCH) * r.sgM;
  const int step_minor = (r.steep ? RS_PITCH : 1) * r.sgm;
  w.step = (int)((unsigned)step_major & 0xffffu |
                 (unsigned)step_minor << 16);
  return w;
}

// Lane l's cell of the ray whose payload lane j holds: its sub-tile
// offset (below 32 x 33), with bit 11 set where the add is +log4 (the
// ray's last in-map slot); -1 where the ray has no slot lo + l.
__device__ __forceinline__ int cell_code(const SubRay& ray_j, int j) {
  const int lane = threadIdx.x & 31;
  const int key = __shfl_sync(RS_ALL, ray_j.key, j);
  const unsigned steps = __shfl_sync(RS_ALL, ray_j.steps, j);
  const int step = __shfl_sync(RS_ALL, ray_j.step, j);
  const int m = __popc(steps & ((1u << lane) - 1u));
  const int at = (key & 0xffff) + (short)step * lane + (step >> 16) * m;
  const int code = at | (lane == ((key >> 16) & 63)) << 11;
  return lane < (key >> 24) ? code : -1;
}

// The position of the (lane + 1)-th set bit of `bits`, for a lane below
// its count of set bits: the last position with at most `lane` set bits
// below it, by binary search.
__device__ __forceinline__ int nth_set_bit(unsigned bits) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
#pragma unroll
  for (int b = 16; b > 0; b >>= 1) {
    if (__popc(bits & ((1u << (pos + b)) - 1u)) <= lane) pos += b;
  }
  return pos;
}

// One scan on a carried grid, in place. A warp owns a 32 x 32 sub-tile
// (see the design note above). With has_clip every warp loads its
// sub-tile, walks, clips and stores it: the clip covers the whole grid.
// Without it, a warp loads its sub-tile only when the first ray that
// touches it arrives, and a warp that no ray touches returns having read
// and written nothing.
__global__ void __launch_bounds__(RS_THREADS)
raywalk_scan_kernel(const int32_t* __restrict__ ends,
                    const uint8_t* __restrict__ mask, int R, int W, int H,
                    int K, float log4, float clip, int has_clip,
                    float* __restrict__ grid) {
  __shared__ float tiles[RS_WARPS][RS_SUB * RS_PITCH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * 2 * RS_SUB + (warp & 1) * RS_SUB;
  const int y0 = blockIdx.y * 2 * RS_SUB + (warp >> 1) * RS_SUB;
  if (x0 >= W || y0 >= H) return;  // warp-uniform; no block barrier here
  const int x1 = x0 + RS_SUB - 1, y1 = y0 + RS_SUB - 1;
  float* tile = tiles[warp];
  bool loaded = false;
  if (has_clip) {
    load_sub(grid, W, H, x0, y0, tile);
    loaded = true;
  }

  // lane l's ray of the current batch, fetched one batch ahead
  bool valid = lane < R && mask[lane];
  int4 e = make_int4(0, 0, 0, 0);
  if (lane < R) {
    const int32_t* p = ends + (size_t)lane * 4;
    e = make_int4(p[0], p[1], p[2], p[3]);
  }
  for (int base = 0; base < R; base += 32) {
    const int next = base + 32 + lane;
    bool valid_next = false;
    int4 e_next = make_int4(0, 0, 0, 0);
    if (next < R) {
      const int32_t* p = ends + (size_t)next * 4;
      e_next = make_int4(p[0], p[1], p[2], p[3]);
      valid_next = mask[next];
    }
    Ray ray;
    int klo, khi, kend;
    clip_ray(e.x, e.y, e.z, e.w, valid, W, H, K, x0, y0, x1, y1, ray, klo,
             khi, kend);
    unsigned hits = __ballot_sync(RS_ALL, klo <= khi);
    if (hits != 0) {
      if (!loaded) {
        load_sub(grid, W, H, x0, y0, tile);
        loaded = true;
      }
      const SubRay mine = klo <= khi ? sub_ray(ray, klo, khi, kend, x0, y0)
                                     : SubRay{0, 0u, 0};
      // lane j takes the payload of the batch's j-th ray that hits the
      // sub-tile (rays in order), so ray j's broadcast comes from lane j
      const int n = __popc(hits);
      const int from = nth_set_bit(hits);
      SubRay ranked;
      ranked.key = __shfl_sync(RS_ALL, mine.key, from);
      ranked.steps = __shfl_sync(RS_ALL, mine.steps, from);
      ranked.step = __shfl_sync(RS_ALL, mine.step, from);
      // the adds in ray order; ray j + 1's cell is computed while ray j's
      // read-add-write is in flight
      int c = cell_code(ranked, 0);
#pragma unroll
      for (int j = 0; j < RS_SUB; ++j) {
        if (j == n) break;  // warp-uniform
        const float old = c >= 0 ? tile[c & 0x7ff] : 0.f;
        const int c_next = cell_code(ranked, (j + 1) & 31);
        const float sum = __fadd_rn(old, (c & 0x800) ? log4 : -log4);
        if (c >= 0) tile[c & 0x7ff] = sum;
        __syncwarp();
        c = c_next;
      }
    }
    valid = valid_next;
    e = e_next;
  }
  if (!loaded) return;
  // lane l clips and stores column y0 + l (the walk ended with __syncwarp)
  const int gy = y0 + lane;
  if (gy >= H) return;
  for (int i = 0; i < RS_SUB && x0 + i < W; ++i) {
    float v = tile[i * RS_PITCH + lane];
    if (has_clip) v = fminf(fmaxf(v, -clip), clip);
    grid[(size_t)(x0 + i) * H + gy] = v;
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

// ends (R, 4) int32 rows (sx, sy, ex, ey) of one scan's rays; mask (R,)
// bool as bytes; grid (W, H) float32, updated in place. has_clip != 0
// clips the whole grid to +/-clip after the walk. Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int slam_raywalk_scan(const void* ends, const void* mask, int R,
                                 int W, int H, int K, float log4, float clip,
                                 int has_clip, void* grid, void* stream) {
  if (W <= 0 || H <= 0) return 0;
  if (R < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  dim3 blocks((W + 2 * RS_SUB - 1) / (2 * RS_SUB),
              (H + 2 * RS_SUB - 1) / (2 * RS_SUB));
  raywalk_scan_kernel<<<blocks, RS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const uint8_t*)mask, R, W, H, K, log4, clip,
      has_clip, (float*)grid);
  return (int)cudaGetLastError();
}
