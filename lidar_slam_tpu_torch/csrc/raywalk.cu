// Two ray-walk kernels of the log-odds map, exact against the scatter path:
//
// raywalk_build: the whole map build (every scan, every ray) in three
// launches, a count and a fill of per-owner ray lists and a walk of those
// lists. Replaces lidar_slam_tpu/ops/raywalk.py::_make_kernel_v11 (launched
// by _build_fused from build_logodds_raywalk, the TPU default), and serves
// the domain of the v1 kernel in raywalk_legacy.py for K > 704: it takes an
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
// What bounds raywalk_build on an H100: not bytes (the 5.8 MB grid and the
// 86 MB of ray ends at the main path's 4,956 x 1,081 rays) and not adds
// (1.29 G visits), but the longest chain of in-order adds that one owner of
// a map region must make. The grid cannot live in one SM's shared memory,
// and a ray-parallel atomicAdd walk would lose the ray order the exactness
// needs, so map regions have owners that walk their rays in order. On the
// main path (chip_smoke.py [5]) 16 x 16 owners are crossed 117 M times in
// all and the hottest one 433,659 times; the walk of that one owner's list
// is most of the build's time (PERF.md gives the times). Owners of 32 x 32
// cross fewer times in all but 0.66 M times at the hottest, and built the
// map more slowly on an H100.
//
// Design of raywalk_build, in three launches:
//  1. bin, count pass. A warp takes a chunk of consecutive rays (in (scan,
//     ray) order), 32 at a time. Each lane computes its ray's in-map slot
//     interval once (clip_ray against the map) and enumerates the owners
//     the ray crosses, in increasing owner id (ox * OH + oy): for each
//     owner column ox between the ray's first and last x, the closed form
//     gives the ray's slots in that column, and its first and last cell
//     there give the owner rows, which the ray crosses every one of. The
//     warp merges its lanes' owner sequences: each round takes the smallest
//     current owner over the lanes (__reduce_min_sync) and the lanes on it
//     (a ballot); the count of (chunk, owner) grows by their number.
//  2. An exclusive scan of the (owner, chunk) count matrix, owner-major,
//     gives each (owner, chunk) its first list position (torch.cumsum in
//     the wrapper, with one host read of the total).
//  3. bin, fill pass: the same merge, writing the global ray index s R + r
//     at the (owner, chunk) cursor plus the lane's rank among the lanes on
//     that owner (lower lanes first). Chunks, batches and lanes are in ray
//     order, so each owner's list is in (scan, ray) order, with no atomic.
//  4. walk. A block owns a 16 x 16 sub-tile (an owner) and reads only its
//     own list, 32 entries a batch. Three feeder warps prepare the batches
//     in turn: lane l takes entry base + l, fetches its ray ends (a slot's
//     next batch is fetched while this one is prepared), clips the ray to
//     the sub-tile (clip_ray; every entry crosses it), lays out its walk
//     as raywalk_scan does (sub_ray) and writes the cells of its slots,
//     two rays a pass, into row j of the batch (ray j's cell of slot
//     lo + l in column l), with a bit for each ray that ends its scan in
//     the list. A ring of three batch slots in shared memory passes them to
//     the walker warp by named barriers (bar.arrive by the writer, bar.sync
//     by the reader; two warps a barrier). The walker loads the sub-tile
//     and walks the batches in order, lane l adding to its column's cell of
//     each ray, one __syncwarp a ray, reading ray j + 1's row while ray j's
//     read-add-write is in flight: its chain holds no tests, divisions or
//     shuffles. It clips the sub-tile after the last ray of each scan in
//     its list, and once at load when S >= 1 and its list is empty or
//     starts after scan 0: the clips of scans that add nothing to the
//     sub-tile change nothing after that one (a clipped value stays put),
//     but an init grid beyond the clip needs it, and clip(v + a) !=
//     clip(clip(v) + a) there.
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
// in-order add from every ray.
//
// Integer division: the closed forms divide negative numerators, and JAX's
// '//' floors while C++ '/' truncates toward zero, so floordiv() is used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RW_BIG = 1 << 28;
constexpr unsigned RS_ALL = 0xffffffffu;
constexpr unsigned RB_NONE = 0xffffffffu;  // a lane with no owner left
constexpr int RB_SUB = 16;  // the side of raywalk_build's owners, in cells

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

// The cell (x, y) at slot k of the ray (k >= 0).
__device__ __forceinline__ void cell_at(const Ray& r, int k, int& x, int& y) {
  const int major = r.sM + r.sgM * k;
  const int minor = r.sm + r.sgm * ((k * r.dm + r.c) / max(r.dM, 1));
  x = r.steep ? minor : major;
  y = r.steep ? major : minor;
}

// The owner rows [oy, oy_end] that the ray's in-map slots [k_in, k_out]
// cross in owner column ox (columns of RB_SUB cells). The ray's cells in
// the column are consecutive slots whose y moves by at most one a slot, so
// the ray crosses every owner row between its first and last cell there.
__device__ __forceinline__ void owner_rows(const Ray& r, int ox, int k_in,
                                           int k_out, int H, int& oy,
                                           int& oy_end) {
  const int x0 = ox * RB_SUB, x1 = x0 + RB_SUB - 1;
  int t_lo, t_hi;
  if (r.steep) {
    interval(r, 0, H - 1, x0, x1, t_lo, t_hi);
  } else {
    interval(r, x0, x1, 0, H - 1, t_lo, t_hi);
  }
  int xa, ya, xb, yb;
  cell_at(r, max(k_in, t_lo), xa, ya);
  cell_at(r, min(k_out, t_hi), xb, yb);
  oy = min(ya, yb) / RB_SUB;  // cells in the map: y >= 0
  oy_end = max(ya, yb) / RB_SUB;
}

// Both binning passes of raywalk_build. Warp w takes the rays [w chunk,
// (w + 1) chunk) of the flat (S R) order. table is (n_owners, n_chunks)
// int32, owner-major. Count pass (entries == nullptr): table starts at zero
// and ends as each (owner, chunk)'s crossing count. Fill pass: table
// starts as the exclusive scan of the counts and each crossing's ray index
// goes to entries at its (owner, chunk) cursor, in ray order.
__global__ void __launch_bounds__(128)
raywalk_bin_kernel(const int32_t* __restrict__ ends,
                   const uint8_t* __restrict__ mask, int n_rays, int W,
                   int H, int K, int chunk, int n_chunks,
                   int* __restrict__ table, int* __restrict__ entries) {
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_chunks) return;  // warp-uniform
  const int OH = (H + RB_SUB - 1) / RB_SUB;
  const unsigned below = (1u << lane) - 1u;
  const int first = w * chunk, last = min(n_rays, first + chunk);
  for (int base = first; base < last; base += 32) {
    const int g = base + lane;
    const bool valid = g < last && mask[g];
    int4 e = make_int4(0, 0, 0, 0);
    if (valid) e = *reinterpret_cast<const int4*>(ends + (size_t)g * 4);
    Ray ray;
    int k_in, k_out, kend;
    clip_ray(e.x, e.y, e.z, e.w, valid, W, H, K, 0, 0, W - 1, H - 1, ray,
             k_in, k_out, kend);
    bool live = k_in <= k_out;
    int ox = 0, ox_end = -1, oy = 0, oy_end = -1;
    if (live) {
      int xa, ya, xb, yb;
      cell_at(ray, k_in, xa, ya);
      cell_at(ray, k_out, xb, yb);
      ox = min(xa, xb) / RB_SUB;
      ox_end = max(xa, xb) / RB_SUB;
      owner_rows(ray, ox, k_in, k_out, H, oy, oy_end);
    }
    // merge the lanes' increasing owner sequences, smallest owner first
    while (true) {
      const unsigned key = live ? (unsigned)(ox * OH + oy) : RB_NONE;
      const unsigned m = __reduce_min_sync(RS_ALL, key);
      if (m == RB_NONE) break;  // warp-uniform
      const bool on = key == m;
      const unsigned group = __ballot_sync(RS_ALL, on);
      const int leader = __ffs(group) - 1;
      const size_t at = (size_t)m * n_chunks + w;
      if (entries == nullptr) {
        // only this warp writes this (owner, chunk) count: the atomic is a
        // store that does not wait for the old value
        if (lane == leader) atomicAdd(table + at, __popc(group));
      } else {
        int cursor = 0;
        if (lane == leader) {
          cursor = table[at];
          table[at] = cursor + __popc(group);
        }
        cursor = __shfl_sync(RS_ALL, cursor, leader);
        if (on) entries[cursor + __popc(group & below)] = g;
      }
      if (on && ++oy > oy_end) {
        if (++ox > ox_end) {
          live = false;
        } else {
          owner_rows(ray, ox, k_in, k_out, H, oy, oy_end);
        }
      }
    }
  }
}

// Copy the warp's SUB x SUB sub-tile in from the grid (zeros past the map's
// edge): lane l < SUB takes column y0 + l of every row.
template <int SUB>
__device__ __forceinline__ void load_sub(const float* __restrict__ grid,
                                         int W, int H, int x0, int y0,
                                         float* tile) {
  const int lane = threadIdx.x & 31, gy = y0 + lane;
  if (lane < SUB) {
#pragma unroll 8
    for (int i = 0; i < SUB; ++i) {
      const int gx = x0 + i;
      tile[i * (SUB + 1) + lane] =
          (gx < W && gy < H) ? grid[(size_t)gx * H + gy] : 0.f;
    }
  }
  __syncwarp();
}

// Clip the warp's sub-tile to +/-clip in shared memory.
template <int SUB>
__device__ __forceinline__ void clip_sub(float* tile, float clip) {
  const int lane = threadIdx.x & 31;
  if (lane < SUB) {
#pragma unroll 8
    for (int i = 0; i < SUB; ++i) {
      float& v = tile[i * (SUB + 1) + lane];
      v = fminf(fmaxf(v, -clip), clip);
    }
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

template <int SUB>
__device__ __forceinline__ SubRay sub_ray(const Ray& r, int lo, int hi,
                                          int end, int x0, int y0) {
  constexpr int PITCH = SUB + 1;  // padded row of the sub-tile
  const int dM = max(r.dM, 1);
  const int num = lo * r.dm + r.c;
  const int q = num / dM;
  const int rem = num - q * dM;  // (lo dm + c) mod dM
  // the SUB - 1 step bits as independent chains of the Bresenham error,
  // each started 8 slots on
  const int e8 = (8 * r.dm) % dM;
  int start = rem;
  unsigned steps = 0;
#pragma unroll
  for (int part = 0; part < SUB / 8; ++part) {
    int err = start;
    start += e8;
    if (start >= dM) start -= dM;
#pragma unroll
    for (int l = part * 8; l < min(part * 8 + 8, SUB - 1); ++l) {
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
  // the last in-map slot's offset is capped at SUB (past the sub-tile)
  w.key = ((x - x0) * PITCH + (y - y0)) | min(end - lo, SUB) << 16 |
          (hi - lo + 1) << 24;
  w.steps = steps;
  const int step_major = (r.steep ? 1 : PITCH) * r.sgM;
  const int step_minor = (r.steep ? PITCH : 1) * r.sgm;
  w.step = (int)((unsigned)step_major & 0xffffu |
                 (unsigned)step_minor << 16);
  return w;
}

// The cell at slot lo + `slot` of the ray whose payload lane j holds: its
// sub-tile offset (below 32 x 33), with bit 11 set where the add is +log4
// (the ray's last in-map slot); -1 where the ray has no such slot.
__device__ __forceinline__ int cell_code_at(const SubRay& ray_j, int j,
                                            int slot) {
  const int key = __shfl_sync(RS_ALL, ray_j.key, j);
  const unsigned steps = __shfl_sync(RS_ALL, ray_j.steps, j);
  const int step = __shfl_sync(RS_ALL, ray_j.step, j);
  const int m = __popc(steps & ((1u << slot) - 1u));
  const int at = (key & 0xffff) + (short)step * slot + (step >> 16) * m;
  const int code = at | (slot == ((key >> 16) & 63)) << 11;
  return slot < (key >> 24) ? code : -1;
}

// Walk rays 0 .. n - 1 in order, one __syncwarp a ray: lane l adds to its
// cell of each, code_of(j) (cell_code_at's code of ray j, or -1). Ray j +
// 1's code is taken while ray j's read-add-write is in flight. Each cell of
// the sub-tile gets its adds in ray order: the walk's exactness rests here.
template <typename CodeOf>
__device__ __forceinline__ void walk_in_order(CodeOf code_of, int n,
                                              float* tile, float log4) {
  int c = code_of(0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j == n) break;  // warp-uniform
    const float old = c >= 0 ? tile[c & 0x7ff] : 0.f;
    const int c_next = code_of(j + 1);
    const float sum = __fadd_rn(old, (c & 0x800) ? log4 : -log4);
    if (c >= 0) tile[c & 0x7ff] = sum;
    __syncwarp();
    c = c_next;
  }
}

// A warp's cells of a batch of rays: row j holds ray j's cell of slot lo +
// l in column l (cell_code_at's codes; -1 past the ray's slots, and in
// columns RB_SUB .. 31). Row 32 is read past a batch's last ray and unused.
constexpr int RB_ROWS = 33;

// The cells of the n rays whose payloads lanes 0 .. n - 1 hold, into rows
// 0 .. n - 1 of codes, 32 / RB_SUB rays a pass.
__device__ __forceinline__ void fill_codes(const SubRay& mine, int n,
                                           int* codes) {
  const int lane = threadIdx.x & 31, slot = lane % RB_SUB;
#pragma unroll 4
  for (int j0 = 0; j0 < n; j0 += 32 / RB_SUB) {  // warp-uniform
    const int j = j0 + lane / RB_SUB;
    const int code = cell_code_at(mine, j & 31, slot);
    if (j < 32) codes[j * 32 + slot] = j < n ? code : -1;
  }
}

// Named barriers between two warps of a block (id 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

constexpr int RB_FEEDERS = 3;  // warps that prepare batches for the walker
constexpr int RB_THREADS = 32 * (1 + RB_FEEDERS);

// One batch of an owner's list, prepared by a feeder warp: the cells of
// its rays, their count, and bit j set where ray j is the last of its scan
// in the list (the sub-tile is clipped after it).
struct Batch {
  int codes[RB_ROWS * 32];
  int count;
  unsigned clip_after;
};

// Feeder f of the list walk: prepares batches f, f + RB_FEEDERS, ... of
// the owner's list (RB_SUB x RB_SUB cells at (x0, y0); n entries) into
// ring slot f, each after the walker has released the slot's previous
// batch. Lane l takes entry base + l: its ray ends, its slots in the
// sub-tile (clip_ray; every entry crosses the sub-tile), its walk layout
// (sub_ray) and its scan; the entries and ray ends of the slot's next
// batch are fetched while this one is prepared.
__device__ __forceinline__ void feed(const int32_t* __restrict__ ends,
                                     const int* __restrict__ list, int n,
                                     int f, int R, int W, int H, int K,
                                     int x0, int y0, Batch& slot) {
  const int lane = threadIdx.x & 31;
  const int x1 = x0 + RB_SUB - 1, y1 = y0 + RB_SUB - 1;
  const int full = 1 + 2 * f, empty = 2 + 2 * f;  // named barrier ids
  constexpr int STRIDE = 32 * RB_FEEDERS;  // entries between a slot's batches
  for (int j = 0; j < RB_ROWS; ++j) slot.codes[j * 32 + lane] = -1;
  auto entry = [&](int at) { return at < n ? list[at] : -1; };
  auto ray = [&](int g) {
    return g >= 0 ? *reinterpret_cast<const int4*>(ends + (size_t)g * 4)
                  : make_int4(0, 0, 0, 0);
  };
  int g = entry(32 * f + lane), g_next = entry(32 * f + STRIDE + lane);
  int4 e = ray(g);
  for (int base = 32 * f; base < n; base += STRIDE) {
    const int g_after = entry(base + 2 * STRIDE + lane);
    const int4 e_next = ray(g_next);
    const int g_first_after = entry(base + 32);  // the next batch's first
    Ray r;
    int klo, khi, kend;
    clip_ray(e.x, e.y, e.z, e.w, g >= 0, W, H, K, x0, y0, x1, y1, r, klo,
             khi, kend);
    const SubRay mine = klo <= khi
                            ? sub_ray<RB_SUB>(r, klo, khi, kend, x0, y0)
                            : SubRay{0, 0u, 0};
    const int scan = g >= 0 ? g / R : -1;
    int scan_after = __shfl_down_sync(RS_ALL, scan, 1);
    if (lane == 31) scan_after = g_first_after >= 0 ? g_first_after / R : -1;
    const unsigned clip_after =
        __ballot_sync(RS_ALL, g >= 0 && scan != scan_after);
    const int count = min(32, n - base);
    if (base >= STRIDE) pair_sync(empty);  // the walker is done with it
    fill_codes(mine, count, slot.codes);
    if (lane == 0) {
      slot.count = count;
      slot.clip_after = clip_after;
    }
    __syncwarp();
    pair_arrive(full);
    g = g_next;
    e = e_next;
    g_next = g_after;
  }
}

// The list walk of raywalk_build. Block b owns sub-tile b (owner id ox OH +
// oy, RB_SUB x RB_SUB cells at x0 = ox RB_SUB, y0 = oy RB_SUB) and its list
// entries[bounds[b] .. bounds[b + 1]) (global ray indices s R + r, in
// order). Warps 1 .. RB_FEEDERS prepare the list's batches in turn (feed);
// warp 0 loads the sub-tile and walks the batches in order from the ring
// of prepared cells, clipping after the last ray of each scan (see the
// design note above), and stores the sub-tile.
__global__ void __launch_bounds__(RB_THREADS)
raywalk_walk_kernel(const int32_t* __restrict__ ends,
                    const int* __restrict__ bounds,
                    const int* __restrict__ entries, int S, int R, int W,
                    int H, int K, float log4, float clip,
                    float* __restrict__ grid) {
  __shared__ float tile[RB_SUB * (RB_SUB + 1)];
  __shared__ Batch ring[RB_FEEDERS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int OH = (H + RB_SUB - 1) / RB_SUB;
  const int owner = blockIdx.x;
  const int x0 = owner / OH * RB_SUB, y0 = owner % OH * RB_SUB;
  const int begin = bounds[owner], n = bounds[owner + 1] - begin;
  const int* list = entries + begin;
  if (warp > 0) {  // warp-uniform
    feed(ends, list, n, warp - 1, R, W, H, K, x0, y0, ring[warp - 1]);
    return;
  }
  load_sub<RB_SUB>(grid, W, H, x0, y0, tile);
  if (S >= 1 && (n == 0 || list[0] >= R)) clip_sub<RB_SUB>(tile, clip);
  const int n_batches = (n + 31) / 32;
  for (int b = 0; b < n_batches; ++b) {
    const int f = b % RB_FEEDERS;
    pair_sync(1 + 2 * f);  // batch b is ready
    const Batch& batch = ring[f];
    const int count = batch.count;
    const unsigned clip_after = batch.clip_after;
    // walk the batch in runs that end where a scan ends
    for (int j0 = 0; j0 < count;) {  // warp-uniform
      const unsigned ends_here = clip_after >> j0;
      const int len = ends_here ? __ffs(ends_here) : count - j0;
      const int* rows = batch.codes + j0 * 32;
      walk_in_order([&](int j) { return rows[j * 32 + lane]; }, len, tile,
                    log4);
      if (ends_here) clip_sub<RB_SUB>(tile, clip);
      j0 += len;
    }
    if (b + RB_FEEDERS < n_batches) pair_arrive(2 + 2 * f);  // slot free
  }
  // lane l < RB_SUB stores column y0 + l (the walk ended with __syncwarp)
  const int gy = y0 + lane;
  if (lane >= RB_SUB || gy >= H) return;
  for (int i = 0; i < RB_SUB && x0 + i < W; ++i) {
    grid[(size_t)(x0 + i) * H + gy] = tile[i * (RB_SUB + 1) + lane];
  }
}

constexpr int RS_SUB = 32;               // a warp's sub-tile side
constexpr int RS_PITCH = RS_SUB + 1;     // padded row of the sub-tile
constexpr int RS_WARPS = 4;              // 2 x 2 sub-tiles a block
constexpr int RS_THREADS = 32 * RS_WARPS;

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
    load_sub<RS_SUB>(grid, W, H, x0, y0, tile);
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
        load_sub<RS_SUB>(grid, W, H, x0, y0, tile);
        loaded = true;
      }
      const SubRay mine = klo <= khi
                              ? sub_ray<RS_SUB>(ray, klo, khi, kend, x0, y0)
                              : SubRay{0, 0u, 0};
      // lane j takes the payload of the batch's j-th ray that hits the
      // sub-tile (rays in order), so ray j's broadcast comes from lane j
      const int from = nth_set_bit(hits);
      SubRay ranked;
      ranked.key = __shfl_sync(RS_ALL, mine.key, from);
      ranked.steps = __shfl_sync(RS_ALL, mine.steps, from);
      ranked.step = __shfl_sync(RS_ALL, mine.step, from);
      walk_in_order(
          [&](int j) { return cell_code_at(ranked, j & 31, lane); },
          __popc(hits), tile, log4);
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

// One binning pass of raywalk_build: ends (n_rays, 4) int32 rows (sx, sy,
// ex, ey), mask (n_rays,) bool as bytes, in (scan, ray) order; table
// (n_owners, n_chunks) int32 over the RB_SUB x RB_SUB owners; entries null
// for the count pass, else the (total,) int32 lists. Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int slam_raywalk_bin(const void* ends, const void* mask,
                                int n_rays, int W, int H, int K, int chunk,
                                int n_chunks, void* table, void* entries,
                                void* stream) {
  if (W <= 0 || H <= 0 || n_chunks <= 0) return 0;
  if (n_rays < 0 || K <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_chunks + 3) / 4;
  raywalk_bin_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const uint8_t*)mask, n_rays, W, H, K, chunk,
      n_chunks, (int*)table, (int*)entries);
  return (int)cudaGetLastError();
}

// The list walk of raywalk_build: ends (S, R, 4) int32; bounds (n_owners +
// 1,) int32 and entries the owners' lists from the binning; grid (W, H)
// float32, read as the initial map and overwritten with the result.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int slam_raywalk_walk(const void* ends, const void* bounds,
                                 const void* entries, int S, int R, int W,
                                 int H, int K, float log4, float clip,
                                 void* grid, void* stream) {
  if (W <= 0 || H <= 0) return 0;
  if (S < 0 || R < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int owners =
      ((W + RB_SUB - 1) / RB_SUB) * ((H + RB_SUB - 1) / RB_SUB);
  raywalk_walk_kernel<<<owners, RB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const int*)bounds, (const int*)entries, S, R, W,
      H, K, log4, clip, (float*)grid);
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
