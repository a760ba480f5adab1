// The port's host runtime without libpng: the texture's native projector
// (slamio_project_frames: RGB-D frames to last-writer-wins paint ops), an
// exact KD-tree and an exact DBSCAN (host-side oracles of the NN and the
// density filter).
//
// A copy of that half of native/slamio.cpp (lidar_slam_tpu/utils/native.py
// binds that one), with the same arithmetic, so its paint ops equal the
// JAX package's bit for bit. lidar_slam_tpu_torch/utils/native.py builds it
// with
//     g++ -O3 -fno-math-errno -fno-trapping-math -fPIC -std=c++17 -Wall
//         -shared slamhost.cpp -o libslamhost_<hash>.so -lpthread
// (no -march=native: a checkout may move between hosts; strict ISO C++
// contracts no multiply-add into an FMA either way). C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Exact KD-tree: the host-side oracle of the brute-force NN
// (lidar_slam_tpu_torch/ops/nn.py and its kernel), standing in for the
// reference's scipy KDTree (modules/icp.py:40,161). Ties in squared distance
// resolve to the LOWEST point index, as the NN's argmin does.
// ---------------------------------------------------------------------------

struct KdTree {
  int dims = 0;
  int n = 0;
  std::vector<float> pts;  // n * dims, row-major
  std::vector<int> order;  // permutation; subtree over order[lo, hi)

  float coord(int point, int axis) const {
    return pts[(size_t)point * dims + axis];
  }

  void build(int lo, int hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % dims;
    int mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi, [&](int a, int b) {
                       float ca = coord(a, axis), cb = coord(b, axis);
                       if (ca != cb) return ca < cb;
                       return a < b;  // deterministic layout
                     });
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  void query_range(const float* q, int lo, int hi, int depth, double* best_d2,
                   int* best_idx) const {
    if (hi <= lo) return;
    int mid = (lo + hi) / 2;
    int pivot = order[mid];
    double d2 = 0.0;
    for (int a = 0; a < dims; ++a) {
      double diff = (double)q[a] - (double)coord(pivot, a);
      d2 += diff * diff;
    }
    if (d2 < *best_d2 || (d2 == *best_d2 && pivot < *best_idx)) {
      *best_d2 = d2;
      *best_idx = pivot;
    }
    if (hi - lo == 1) return;
    int axis = depth % dims;
    double diff = (double)q[axis] - (double)coord(pivot, axis);
    int near_lo = diff < 0 ? lo : mid + 1, near_hi = diff < 0 ? mid : hi;
    int far_lo = diff < 0 ? mid + 1 : lo, far_hi = diff < 0 ? hi : mid;
    query_range(q, near_lo, near_hi, depth + 1, best_d2, best_idx);
    // prune the far side only when the splitting plane is STRICTLY farther
    // than the best: a point AT best_d2 there could have a lower index.
    if (diff * diff <= *best_d2)
      query_range(q, far_lo, far_hi, depth + 1, best_d2, best_idx);
  }
};

}  // namespace

extern "C" {

void* slamio_kdtree_build(const float* pts, int n, int dims) {
  if (n <= 0 || dims <= 0 || dims > 8) return nullptr;
  KdTree* tree = new KdTree;
  tree->dims = dims;
  tree->n = n;
  tree->pts.assign(pts, pts + (size_t)n * dims);
  tree->order.resize(n);
  for (int i = 0; i < n; ++i) tree->order[i] = i;
  tree->build(0, n, 0);
  return tree;
}

// Exact 1-NN for each query row; out_idx[i] = index into the build points,
// out_d2[i] = true squared distance (double-accumulated, rounded to f32).
void slamio_kdtree_query(void* handle, const float* queries, int nq,
                         int* out_idx, float* out_d2) {
  const KdTree* tree = static_cast<const KdTree*>(handle);
  for (int i = 0; i < nq; ++i) {
    double best_d2 = 1e300;
    int best_idx = -1;
    tree->query_range(queries + (size_t)i * tree->dims, 0, tree->n, 0,
                      &best_d2, &best_idx);
    out_idx[i] = best_idx;
    out_d2[i] = (float)best_d2;
  }
}

void slamio_kdtree_free(void* handle) {
  delete static_cast<KdTree*>(handle);
}

// ---------------------------------------------------------------------------
// Exact DBSCAN: the host-side oracle of the density filter
// (lidar_slam_tpu_torch/ops/filters.py), standing in for the reference's
// sklearn DBSCAN (modules/localization.py:216-217): index-order BFS over the
// <= eps neighbourhood graph (self counted, as sklearn), O(n^2). labels[i]
// receives the cluster id (0..k-1) or -1 for noise. Returns the cluster
// count, or -1 on bad arguments. Border points take the cluster of the first
// core point that reaches them in BFS order (sklearn's semantics).
// ---------------------------------------------------------------------------

int slamio_dbscan(const float* pts, int n, int dims, float eps,
                  int min_samples, int* labels) {
  if (n < 0 || dims <= 0 || dims > 8 || eps < 0) return -1;
  const double eps2 = (double)eps * (double)eps;
  auto d2 = [&](int a, int b) {
    double s = 0.0;
    for (int k = 0; k < dims; ++k) {
      double diff = (double)pts[(size_t)a * dims + k] -
                    (double)pts[(size_t)b * dims + k];
      s += diff * diff;
    }
    return s;
  };
  std::vector<std::vector<int>> neigh(n);
  std::vector<bool> core(n, false);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j)
      if (d2(i, j) <= eps2) neigh[i].push_back(j);
    core[i] = (int)neigh[i].size() >= min_samples;
  }
  for (int i = 0; i < n; ++i) labels[i] = -1;
  int next_label = 0;
  std::vector<int> queue;
  for (int i = 0; i < n; ++i) {
    if (!core[i] || labels[i] != -1) continue;
    int lab = next_label++;
    labels[i] = lab;
    queue.assign(1, i);
    while (!queue.empty()) {
      int p = queue.back();
      queue.pop_back();
      for (int q : neigh[p]) {
        if (labels[q] != -1) continue;
        labels[q] = lab;          // border or core reached by this cluster
        if (core[q]) queue.push_back(q);
      }
    }
  }
  return next_label;
}

// ---------------------------------------------------------------------------
// RGB-D frame projection: the texture's "native" engine
// (lidar_slam_tpu_torch/models/texture.py). It runs the unproject chain
// (reference: modules/texture_mapping.py:134-224) on the host in double
// precision, algebraically collapsed (reciprocal multiplies for the grid and
// registration quotients, hoisted pose terms), and emits only each frame's
// LAST-WRITER-WINS (cell, color) paint ops, which the device folds with the
// same scatter-max as the device engine's points. A pixel within a rounding
// of a cell or registration boundary can land apart from the device
// engine's float32 chain (measure-zero boundary divergence). Dtype flow as
// the reference's numpy code: disparity -> depth in float32, everything
// downstream in float64.
// ---------------------------------------------------------------------------

// cam16: [fx, fy, cx, cy, pitch_deg, p_rc0, p_rc1, p_rc2, disp_a, disp_b,
//         depth_scale, reg_scale, reg_i_off, reg_dd, reg_j_off, reg_div]
// Emits, per frame f, counts[f] unique (cell, packed r|g<<8|b<<16) pairs in
// first-touch order (within a frame each cell appears once, so any order
// reproduces the frame's final writes); frames are emitted in order, so a
// device scatter-max of global sequence numbers reproduces the reference's
// cross-frame last-writer-wins exactly. Returns the total pair count, or -1
// when `cap` would overflow (caller sizes cap = B*H*W, the true upper bound).
int slamio_project_frames(const uint16_t* disp, const uint8_t* rgb,
                          const double* poses, int B, int H, int W,
                          const double* cam16, double min_x, double min_y,
                          double res, int grid_w, int grid_h,
                          int32_t* out_cells, int32_t* out_colors,
                          int32_t* out_counts, long long cap,
                          int n_threads) {
  const double fx = cam16[0], fy = cam16[1], cx = cam16[2], cy = cam16[3];
  const double pitch = cam16[4] * 3.141592653589793 / 180.0;
  const double prc0 = cam16[5], prc1 = cam16[6];  // p_rc z unused in 2-D grid
  const float disp_a = (float)cam16[8], disp_b = (float)cam16[9];
  const float depth_scale = (float)cam16[10];
  const double reg_scale = cam16[11], reg_i_off = cam16[12];
  const double reg_dd = cam16[13], reg_j_off = cam16[14], reg_div = cam16[15];
  const double inv_reg_div = 1.0 / reg_div;
  const double inv_res = 1.0 / res;
  // K^-1 analytic (K upper triangular): ray = ((j - cx)/fx, (i - cy)/fy, 1)
  const double ki00 = 1.0 / fx, ki02 = -cx / fx;
  const double ki11 = 1.0 / fy, ki12 = -cy / fy;
  const double cp = std::cos(pitch), sp = std::sin(pitch);

  // disparity-indexed tables: depth and the f32 reg_dd*depth product depend
  // only on the uint16 disparity value — 64K entries amortize the per-pixel
  // f32 divide away (reference dtype flow: disparity -> depth in float32,
  // texture_mapping.py:130-141)
  // interleaved {depth, reg_dd*depth} pairs: one index computation and one
  // cache line serve both per-pixel loads in the table pre-pass
  std::vector<double> tbl(2 * 65536);
  for (int d = 0; d < 65536; ++d) {
    float dd = disp_a * (float)d + disp_b;
    float depth_f = depth_scale / dd;
    tbl[2 * d] = (double)depth_f;
    tbl[2 * d + 1] = (double)((float)reg_dd * depth_f);
  }
  // column tables: registered-RGB column and the optical-x ray slope are
  // functions of j alone
  std::vector<double> u_col(W);
  std::vector<int32_t> vj_col(W);
  std::vector<uint8_t> colok(W);
  for (int j = 0; j < W; ++j) {
    u_col[j] = j * ki00 + ki02;
    double rgbj = (reg_scale * j + reg_j_off) / reg_div;
    colok[j] = (rgbj >= 0.0 && rgbj < W) ? 1 : 0;
    int vj = colok[j] ? (int)rgbj : 0;
    vj_col[j] = vj > W - 1 ? W - 1 : vj;
  }

  // per-frame dedupe slots, versioned by frame tag so they reset for free
  const long long ncells = (long long)grid_w * grid_h;

  std::vector<long long> frame_count(B, 0);
  std::vector<std::vector<int32_t>> frame_cells(B), frame_colors(B);

  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  auto worker = [&]() {
    // local copies of the by-reference-captured scalars: a captured int
    // lives in the closure frame, so int32 stores through the row pointers
    // could alias it — which blocks the trip-count computation and keeps
    // the hot loop scalar. Locals without their address taken cannot alias.
    const int Wl = W, Hl = H, gw = grid_w, gh = grid_h;
    // first pass per frame writes colors into color_slot[cell]; `seen`
    // carries the frame tag of the last write so no O(ncells) clear is
    // needed per frame
    std::vector<int32_t> seen(ncells, -1), color_slot(ncells);
    std::vector<int32_t> touched;
    std::vector<int32_t> cell_row(W), vi_row(W);
    std::vector<double> Bu(W), Eu(W), depth_row(W), regdd_row(W);
    for (;;) {
      int f;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= B) return;
        f = next[0]++;
      }
      touched.clear();
      const uint16_t* dframe = disp + (size_t)f * Hl * Wl;
      const uint8_t* rframe = rgb + (size_t)f * Hl * Wl * 3;
      const double px = poses[3 * f], py = poses[3 * f + 1];
      const double yaw = poses[3 * f + 2];
      const double cyw = std::cos(yaw), syw = std::sin(yaw);
      // hoisted frame constants: the optical->camera->robot->world chain
      // collapses to  xw = depth*(A_i + Bu_j) + Cx,  yw = depth*(D_i + Eu_j)
      // + Cy  with A/D functions of the row and Bu/Eu of the column
      // (optical->camera is the fixed axis permutation R_oc^T; camera->robot
      // the pitch rotation + p_rc; robot->world the pose yaw + translation)
      const double Cx = cyw * prc0 - syw * prc1 + px;
      const double Cy = syw * prc0 + cyw * prc1 + py;
      for (int j = 0; j < Wl; ++j) {
        Bu[j] = syw * u_col[j];
        Eu[j] = -cyw * u_col[j];
      }
      for (int i = 0; i < Hl; ++i) {
        const double v_i = i * ki11 + ki12;      // optical-y ray slope
        const double rx_i = cp - sp * v_i;       // robot-x per unit depth
        const double A_i = cyw * rx_i, D_i = syw * rx_i;
        const double rowterm = reg_scale * i + reg_i_off;
        const uint16_t* drow = dframe + (size_t)i * Wl;
        // scalar table pre-pass (data-dependent loads block the
        // autovectorizer; isolated here they are ~2 cycles each)
        for (int j = 0; j < Wl; ++j) {
          const double* e = &tbl[2 * (uint32_t)drow[j]];
          depth_row[j] = e[0];
          regdd_row[j] = e[1];
        }
        // vector pass: pure per-pixel math, branchless, autovectorizable
        for (int j = 0; j < Wl; ++j) {
          double depth = depth_row[j];
          // registered RGB row (depth passed into the dd slot — reference
          // quirk, texture_mapping.py:198)
          double rgbi = (rowterm - regdd_row[j]) * inv_reg_div;
          double xw = depth * (A_i + Bu[j]) + Cx;
          double yw = depth * (D_i + Eu[j]) + Cy;
          double gi = std::ceil((xw - min_x) * inv_res) - 1.0;
          double gj = std::ceil((yw - min_y) * inv_res) - 1.0;
          // NaN/inf depth (dd <= 0) fails every comparison, like numpy
          bool ok = bool(colok[j]) & (rgbi >= 0.0) & (rgbi < Hl) &
                    (gi >= 0.0) & (gi < gw) & (gj >= 0.0) & (gj < gh);
          // select BEFORE the double->int32 casts: out-of-range/NaN
          // conversion is UB in the abstract machine, and the unspeculable
          // casts were also what kept this loop scalar (gcc cannot
          // if-convert a trapping conversion; with the selects the casts
          // are unconditionally in-range and the loop vectorizes)
          double gis = ok ? gi : 0.0, gjs = ok ? gj : 0.0;
          double ris = ok ? rgbi : 0.0;
          cell_row[j] = ok ? (int32_t)gis * gh + (int32_t)gjs : -1;
          // registered source pixel (trunc == astype(int); gated by ok)
          vi_row[j] = (int32_t)ris * Wl + vj_col[j];
        }
        // scalar pass: per-frame last-writer-wins dedupe; the winning
        // SOURCE PIXEL index is recorded and its color fetched once per
        // touched cell at frame end (~100x fewer gathers than per-pixel)
        for (int j = 0; j < Wl; ++j) {
          int32_t cell = cell_row[j];
          if (cell < 0) continue;
          if (seen[cell] != f) {
            seen[cell] = f;
            touched.push_back(cell);
          }
          color_slot[cell] = vi_row[j];  // later pixels overwrite
        }
      }
      frame_count[f] = (long long)touched.size();
      frame_cells[f].assign(touched.begin(), touched.end());
      frame_colors[f].resize(touched.size());
      for (size_t k = 0; k < touched.size(); ++k) {
        const uint8_t* c = rframe + (size_t)color_slot[touched[k]] * 3;
        frame_colors[f][k] = (int32_t)c[0] | ((int32_t)c[1] << 8) |
                             ((int32_t)c[2] << 16);
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > B) nt = B;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();

  long long total = 0;
  for (int f = 0; f < B; ++f) total += frame_count[f];
  if (total > cap) return -1;
  long long off = 0;
  for (int f = 0; f < B; ++f) {
    out_counts[f] = (int32_t)frame_count[f];
    std::memcpy(out_cells + off, frame_cells[f].data(),
                frame_count[f] * sizeof(int32_t));
    std::memcpy(out_colors + off, frame_colors[f].data(),
                frame_count[f] * sizeof(int32_t));
    off += frame_count[f];
  }
  return (int)total;
}

}  // extern "C"
