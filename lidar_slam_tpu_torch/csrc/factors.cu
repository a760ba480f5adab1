// factors (K7): the factor work of each pose-graph LM iteration, in one
// launch each: the linearization, the banded assembly and the cost.
//
// Replaces no Pallas kernel. The JAX package linearizes the factors with
// jax.jacfwd under vmap inside the jitted LM loop of
// lidar_slam_tpu/models/pose_graph.py, which XLA compiles into one
// program. The port's op-by-op version (models/pose_graph.py: _linearize,
// _cost, _banded_system) runs the same functions from Python: at the
// offline cells' shape (4,956 poses, 4,955 between factors, 495 loops) an
// iteration is about 2,400 torch operations, most of them the batching
// machinery of torch.func, which hold the card idle while the host
// dispatches them.
//
// The factors: the prior r = Log(T_prior^-1 T_0) * s_p, the between factors
// and the loops r = Log(m^-1 T_i^-1 T_j) * s, whitened by the inverse sigmas
// s; each loop weighted by its gate w and, under a robust kernel (Huber or
// Cauchy), by sqrt(w_robust(|r|^2)) (IRLS). Log is GTSAM's Pose2 chart: the
// angle omega = atan2(E10, E00) of E = m^-1 T_i^-1 T_j, and
// v = V(omega)^-1 t with a = sin(omega)/omega, b = (1 - cos(omega))/omega,
// v = ((a tx + b ty), (a ty - b tx)) / (a^2 + b^2); below |omega| < 1e-6
// the series a = 1 - omega^2/6, b = omega/2 (utils/se2._ab).
//
// The Jacobian blocks with respect to the raw pose coordinates (x, y,
// theta) are the derivatives torch.func.jacfwd takes of that function, in
// closed form. With E's rotation rows from A = R_m^T, t = A u + b, u =
// R_i^T (t_j - t_i) and P = A R_i^T:
//   d t / d t_j = P, d t / d t_i = -P, d t / d theta_i = A (u_y, -u_x),
//   d t / d theta_j = 0;
//   d omega / d theta_j = q = (E00 E11 - E10 E01) / (E00^2 + E10^2),
//   d omega / d theta_i = -q, since d R / d theta = R S with S the 90 degree
//   rotation, which commutes with every rotation;
//   d v / d t = [[a, b], [-b, a]] / den, d v / d omega = ((a' tx + b' ty),
//   (a' ty - b' tx)) / den - v den' / den, den' = 2 (a a' + b b'), and
//   a' = (cos(omega) - a) / omega, b' = (sin(omega) - b) / omega (series:
//   a' = -omega/3, b' = 1/2).
// kernels/factors._factor_plain writes the same terms in PyTorch.
//
// Launches:
//   (a) k7_linearize, a thread a pose: every factor that touches the pose
//       (the pose-to-factor index of kernels/factors.prepare, in the order
//       the op-by-op path adds into a pose), its residual and blocks,
//       g_k = sum J_k^T r after the prior's; the thread on a factor's first
//       pose writes its blocks. Each between factor is evaluated by both
//       of its poses: that doubles the factor arithmetic (a few hundred
//       float64 operations a factor) and saves a launch and the scattered
//       adds a second pass would need;
//   (b) k7_banded, a thread a 3 x 3 pose block of the super-block
//       tridiagonal storage K6 reads (A_sup, O_sup): the diagonal blocks
//       sum J^T J over the pose's factors, then lam I (the identity on a
//       padded tail pose); an off-diagonal block H[r, c] sums the factors
//       that join poses r and c, found in c's list; the upper blocks of
//       A_sup are the lower ones transposed; the diagonal threads also
//       write the right-hand side -g;
//   (c) k7_cost, one block: each thread sums the cost of every 1,024th
//       factor, then a tree in shared memory, in a fixed order.
// No float atomics anywhere: a result repeats bit for bit from run to run
// (index_add_ on CUDA tensors does not).
//
// Precision: the poses, measurements, blocks and outputs are float32 or
// float64 (the LM's dtype); every operation inside is float64, and each
// output is rounded once.
//
// What bounds it on an H100: latency, not work or bytes. At the cells'
// shape the inputs are about 0.4 MB and the outputs (blocks, A_sup and
// O_sup of 496 x 30 x 30) about 4 MB, a microsecond or two at 3.35 TB/s;
// the factor arithmetic is a few MFLOP in float64. Each launch is one
// wave of short threads, so its time is a launch and a thread's chain of
// float64 transcendentals (sincos, atan2) and loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int K7_THREADS = 128;        // (a), (b): threads a block
constexpr int K7_COST_THREADS = 1024;  // (c): its one block
constexpr double K7_SERIES = 1e-6;     // utils/se2._ab's series branch

// The LM problem as kernels/factors.FactorGraph holds it. Factor f < nb is
// between factor f, else loop f - nb; it joins poses fi[f] -> fj[f].
struct Graph {
  const int *fi, *fj;           // (F,)
  const void* btw_meas;         // (nb, 3, 3)
  const void* loop_meas;        // (F - nb, 3, 3)
  const void* loop_weight;      // (F - nb,) the gate
  const void* consts;           // T_prior^-1 (9), s_prior, s_btw, s_loop
  const int *start, *entries;   // pose k's 2 f + side: start[k]..start[k+1]
  int n, nb, F, robust;         // robust: 0 none, 1 Huber, 2 Cauchy
  double delta;
  bool f64;                     // poses and outputs float64, else float32
};

// Entry i of an array in the graph's dtype. One kernel serves both dtypes
// (a uniform branch a load), as K6's does.
__device__ __forceinline__ double load(const void* p, size_t i,
                                       const Graph& g) {
  return g.f64 ? ((const double*)p)[i] : (double)((const float*)p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, double v,
                                      const Graph& g) {
  if (g.f64)
    ((double*)p)[i] = v;
  else
    ((float*)p)[i] = (float)v;
}

// A factor's whitened (weighted, reweighted) residual and blocks.
struct Lin {
  double r[3], Ji[9], Jj[9];
};

// r = Log(Minv T(pi)^-1 T(pj)) * s and, with jac, its blocks d r / d pi
// and d r / d pj (row-major 3 x 3); Minv = [A | b] (2 x 3, row-major).
__device__ void log_factor(const double* pi, const double* pj,
                           const double* Minv, const double* s, bool jac,
                           Lin& L) {
  double si, ci, sj, cj;
  sincos(pi[2], &si, &ci);
  sincos(pj[2], &sj, &cj);
  const double dx = pj[0] - pi[0], dy = pj[1] - pi[1];
  const double ux = ci * dx + si * dy, uy = ci * dy - si * dx;
  const double r00 = ci * cj + si * sj, r01 = si * cj - ci * sj;
  const double r10 = ci * sj - si * cj, r11 = ci * cj + si * sj;
  const double A00 = Minv[0], A01 = Minv[1], b0 = Minv[2];
  const double A10 = Minv[3], A11 = Minv[4], b1 = Minv[5];
  const double E00 = A00 * r00 + A01 * r10, E01 = A00 * r01 + A01 * r11;
  const double E10 = A10 * r00 + A11 * r10, E11 = A10 * r01 + A11 * r11;
  const double tx = A00 * ux + A01 * uy + b0, ty = A10 * ux + A11 * uy + b1;
  const double om = atan2(E10, E00);
  const bool small = fabs(om) < K7_SERIES;
  const double w = small ? 1.0 : om;
  double sw, cw;
  sincos(w, &sw, &cw);
  const double a = small ? 1.0 - om * om / 6.0 : sw / w;
  const double b = small ? om / 2.0 : (1.0 - cw) / w;
  const double den = a * a + b * b;
  const double vx = (a * tx + b * ty) / den, vy = (a * ty - b * tx) / den;
  L.r[0] = vx * s[0];
  L.r[1] = vy * s[1];
  L.r[2] = om * s[2];
  if (!jac) return;
  const double q = (E00 * E11 - E10 * E01) / (E00 * E00 + E10 * E10);
  const double da = small ? -om / 3.0 : (cw - a) / w;
  const double db = small ? 0.5 : (sw - b) / w;
  const double dden = 2.0 * (a * da + b * db);
  const double gx = (da * tx + db * ty - vx * dden) / den;
  const double gy = (da * ty - db * tx - vy * dden) / den;
  const double P00 = A00 * ci - A01 * si, P01 = A00 * si + A01 * ci;
  const double P10 = A10 * ci - A11 * si, P11 = A10 * si + A11 * ci;
  const double tqx = A00 * uy - A01 * ux, tqy = A10 * uy - A11 * ux;
  const double j00 = (a * P00 + b * P10) / den;
  const double j01 = (a * P01 + b * P11) / den;
  const double j10 = (a * P10 - b * P00) / den;
  const double j11 = (a * P11 - b * P01) / den;
  L.Jj[0] = j00 * s[0];
  L.Jj[1] = j01 * s[0];
  L.Jj[2] = gx * q * s[0];
  L.Jj[3] = j10 * s[1];
  L.Jj[4] = j11 * s[1];
  L.Jj[5] = gy * q * s[1];
  L.Jj[6] = 0.0;
  L.Jj[7] = 0.0;
  L.Jj[8] = q * s[2];
  L.Ji[0] = -j00 * s[0];
  L.Ji[1] = -j01 * s[0];
  L.Ji[2] = ((a * tqx + b * tqy) / den - gx * q) * s[0];
  L.Ji[3] = -j10 * s[1];
  L.Ji[4] = -j11 * s[1];
  L.Ji[5] = ((a * tqy - b * tqx) / den - gy * q) * s[1];
  L.Ji[6] = 0.0;
  L.Ji[7] = 0.0;
  L.Ji[8] = -q * s[2];
}

__device__ __forceinline__ void load_pose(const void* x, int k,
                                          const Graph& g, double* p) {
  for (int c = 0; c < 3; ++c) p[c] = load(x, (size_t)k * 3 + c, g);
}

// The prior's residual and block (Jj) at pose 0.
__device__ void prior(const void* x, const Graph& g, bool jac, Lin& L) {
  double Minv[6], s[3], p0[3], zero[3] = {0.0, 0.0, 0.0};
  for (int c = 0; c < 6; ++c) Minv[c] = load(g.consts, c, g);
  for (int c = 0; c < 3; ++c) s[c] = load(g.consts, 9 + c, g);
  load_pose(x, 0, g, p0);
  log_factor(zero, p0, Minv, s, jac, L);
}

// Factor f's residual and (with jac) blocks, weighted by its gate and,
// for a loop under a robust kernel, reweighted; *e2 (a loop's squared
// norm before the reweighting, 0 for a between factor) where given.
__device__ void factor(const void* x, const Graph& g, int f, bool jac,
                       Lin& L, double* e2) {
  const bool loop = f >= g.nb;
  const void* meas = loop ? g.loop_meas : g.btw_meas;
  const size_t m = (size_t)(loop ? f - g.nb : f) * 9;
  const double m00 = load(meas, m, g), m01 = load(meas, m + 1, g);
  const double m02 = load(meas, m + 2, g), m10 = load(meas, m + 3, g);
  const double m11 = load(meas, m + 4, g), m12 = load(meas, m + 5, g);
  // m^-1 = [R^T | -R^T t], as utils/se2.inverse_T forms it
  const double Minv[6] = {m00, m10, -(m00 * m02 + m10 * m12),
                          m01, m11, -(m01 * m02 + m11 * m12)};
  double s[3], pi[3], pj[3];
  for (int c = 0; c < 3; ++c) s[c] = load(g.consts, (loop ? 15 : 12) + c, g);
  load_pose(x, g.fi[f], g, pi);
  load_pose(x, g.fj[f], g, pj);
  log_factor(pi, pj, Minv, s, jac, L);
  double scale = loop ? load(g.loop_weight, f - g.nb, g) : 1.0;
  if (loop) {
    double sq = 0.0;
    for (int c = 0; c < 3; ++c) {
      L.r[c] *= scale;
      sq += L.r[c] * L.r[c];
    }
    if (e2) *e2 = sq;
    if (jac)
      for (int c = 0; c < 9; ++c) {
        L.Ji[c] *= scale;
        L.Jj[c] *= scale;
      }
    if (g.robust == 0 || !jac) return;
    // IRLS: sqrt of pose_graph._robust_w_rho's weight
    double wr;
    if (g.robust == 1) {
      const double e = sqrt(sq);
      wr = e > g.delta ? g.delta / fmax(e, 1e-30) : 1.0;
    } else {
      wr = 1.0 / (1.0 + sq / (g.delta * g.delta));
    }
    scale = sqrt(wr);
    for (int c = 0; c < 3; ++c) L.r[c] *= scale;
    for (int c = 0; c < 9; ++c) {
      L.Ji[c] *= scale;
      L.Jj[c] *= scale;
    }
  } else if (e2) {
    *e2 = 0.0;
  }
}

// J^T r of a 3 x 3 block (row-major) into acc.
__device__ __forceinline__ void add_jtr(const double* J, const double* r,
                                        double* acc) {
  for (int c = 0; c < 3; ++c)
    acc[c] += J[c] * r[0] + J[3 + c] * r[1] + J[6 + c] * r[2];
}

// (a) a thread a pose: the factors' blocks and the gradient. out holds Jp
// (9), the between blocks Ji (9 nb) and Jj (9 nb), the loops' Ji and Jj
// (9 (F - nb) each), then g (3 n).
__global__ void __launch_bounds__(K7_THREADS)
k7_linearize(const void* __restrict__ x, Graph g, void* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= g.n) return;
  const size_t nb = g.nb, nl = g.F - g.nb;
  double acc[3] = {0.0, 0.0, 0.0};
  Lin L;
  if (k == 0) {
    prior(x, g, true, L);
    add_jtr(L.Jj, L.r, acc);
    for (int c = 0; c < 9; ++c) store(out, c, L.Jj[c], g);
  }
  for (int e = g.start[k]; e < g.start[k + 1]; ++e) {
    const int code = g.entries[e], f = code >> 1, side = code & 1;
    factor(x, g, f, true, L, nullptr);
    double c3[3] = {0.0, 0.0, 0.0};
    add_jtr(side ? L.Jj : L.Ji, L.r, c3);
    for (int c = 0; c < 3; ++c) acc[c] += c3[c];
    if (side) continue;  // the factor's first pose writes its blocks
    const bool loop = f >= g.nb;
    const size_t oi = loop ? 9 + 18 * nb + 9 * (size_t)(f - g.nb)
                           : 9 + 9 * (size_t)f;
    const size_t oj = oi + 9 * (loop ? nl : nb);
    for (int c = 0; c < 9; ++c) {
      store(out, oi + c, L.Ji[c], g);
      store(out, oj + c, L.Jj[c], g);
    }
  }
  const size_t og = 9 + 18 * (size_t)g.F + 3 * (size_t)k;
  for (int c = 0; c < 3; ++c) store(out, og + c, acc[c], g);
}

// The blocks (3 x 3) written by (a): Jp, Jbi, Jbj, Jli, Jlj.
struct Blocks {
  const void *Jp, *Jbi, *Jbj, *Jli, *Jlj;
};

__device__ __forceinline__ void load_block(const void* p, size_t f,
                                           const Graph& g, double* J) {
  for (int c = 0; c < 9; ++c) J[c] = load(p, f * 9 + c, g);
}

// Factor f's blocks, from (a)'s output.
__device__ __forceinline__ void factor_blocks(const Blocks& B, int f,
                                              const Graph& g, double* Ji,
                                              double* Jj) {
  const bool loop = f >= g.nb;
  const size_t i = loop ? f - g.nb : f;
  load_block(loop ? B.Jli : B.Jbi, i, g, Ji);
  load_block(loop ? B.Jlj : B.Jbj, i, g, Jj);
}

// H += Ja^T Jb (3 x 3, row-major)
__device__ __forceinline__ void add_jtj(const double* Ja, const double* Jb,
                                        double* H) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      H[i * 3 + j] += Ja[i] * Jb[j] + Ja[3 + i] * Jb[3 + j] +
                      Ja[6 + i] * Jb[6 + j];
}

// H[r, c] (r > c, both poses of the graph): the factors joining them, from
// c's list: J_j^T J_i for fi = c, fj = r; J_i^T J_j for fi = r, fj = c.
__device__ void coupling(const Graph& g, const Blocks& B, int r, int c,
                         double* H) {
  double Ji[9], Jj[9];
  for (int e = g.start[c]; e < g.start[c + 1]; ++e) {
    const int code = g.entries[e], f = code >> 1, side = code & 1;
    if ((side ? g.fi[f] : g.fj[f]) != r) continue;
    factor_blocks(B, f, g, Ji, Jj);
    if (side)
      add_jtj(Ji, Jj, H);
    else
      add_jtj(Jj, Ji, H);
  }
}

// (b) a thread a 3 x 3 pose block of A_sup (n_sup G^2 of them, then) O_sup
// (n_o G^2), each block written whole; R = -g by the diagonal blocks.
__global__ void __launch_bounds__(K7_THREADS)
k7_banded(const void* __restrict__ grad, Graph g, Blocks B,
          const void* __restrict__ lam, int G, int pad, int n_sup, int n_o,
          void* __restrict__ A, void* __restrict__ O, void* __restrict__ R) {
  const long long GG = (long long)G * G;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n_sup + n_o) * GG) return;
  const bool in_o = t >= n_sup * GG;
  if (in_o) t -= n_sup * GG;
  const int s = (int)(t / GG), a = (int)(t / G % G), b = (int)(t % G);
  const int pr = (s + in_o) * G + a, pc = s * G + b;  // the block's poses
  double H[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (pr == pc) {
    if (pr < g.n) {
      double Ji[9], Jj[9];
      if (pr == 0) {
        load_block(B.Jp, 0, g, Jj);
        add_jtj(Jj, Jj, H);
      }
      for (int e = g.start[pr]; e < g.start[pr + 1]; ++e) {
        const int code = g.entries[e], f = code >> 1, side = code & 1;
        factor_blocks(B, f, g, Ji, Jj);
        double own[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
        add_jtj(side ? Jj : Ji, side ? Jj : Ji, own);
        if (!side && g.fj[f] == pr) {  // a self-loop: both cross terms
          add_jtj(Jj, Ji, own);
          add_jtj(Ji, Jj, own);
        }
        for (int c = 0; c < 9; ++c) H[c] += own[c];
      }
      const double l = load(lam, 0, g);
      for (int c = 0; c < 3; ++c) H[4 * c] += l;
    } else if (pad) {
      for (int c = 0; c < 3; ++c) H[4 * c] = 1.0;
    }
    for (int c = 0; c < 3; ++c)
      store(R, (size_t)pr * 3 + c,
            pr < g.n ? -load(grad, (size_t)pr * 3 + c, g) : 0.0, g);
  } else if (pr < g.n && pc < g.n) {
    if (pr > pc) {
      coupling(g, B, pr, pc, H);
    } else {
      double T[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      coupling(g, B, pc, pr, T);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) H[i * 3 + j] = T[j * 3 + i];
    }
  }
  void* dst = in_o ? O : A;
  const size_t bs = 3 * (size_t)G;
  const size_t base = (size_t)s * bs * bs + (size_t)(3 * a) * bs + 3 * b;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) store(dst, base + i * bs + j, H[i * 3 + j], g);
}

// A factor's cost: 0.5 |r|^2, or a loop's robust rho.
__device__ double factor_cost(const void* x, const Graph& g, int f) {
  Lin L;
  double e2;
  factor(x, g, f, false, L, &e2);
  if (f < g.nb || g.robust == 0)
    return 0.5 * (L.r[0] * L.r[0] + L.r[1] * L.r[1] + L.r[2] * L.r[2]);
  const double d = g.delta;
  if (g.robust == 1) {
    const double e = sqrt(e2);
    return e > d ? d * e - 0.5 * d * d : 0.5 * e2;
  }
  return 0.5 * d * d * log1p(e2 / (d * d));
}

// (c) one block: the cost, summed in a fixed order.
__global__ void __launch_bounds__(K7_COST_THREADS)
k7_cost(const void* __restrict__ x, Graph g, void* __restrict__ out) {
  __shared__ double part[K7_COST_THREADS];
  const int t = threadIdx.x;
  double acc = 0.0;
  if (t == 0) {
    Lin L;
    prior(x, g, false, L);
    acc = 0.5 * (L.r[0] * L.r[0] + L.r[1] * L.r[1] + L.r[2] * L.r[2]);
  }
  for (int f = t; f < g.F; f += K7_COST_THREADS) acc += factor_cost(x, g, f);
  part[t] = acc;
  __syncthreads();
  for (int h = K7_COST_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) part[t] += part[t + h];
    __syncthreads();
  }
  if (t == 0) store(out, 0, part[0], g);
}

Graph make_graph(const int* fi, const int* fj, const void* btw_meas,
                 const void* loop_meas, const void* loop_weight,
                 const void* consts, const int* start, const int* entries,
                 int n, int nb, int F, int robust, double delta,
                 int is_double) {
  Graph g;
  g.fi = fi;
  g.fj = fj;
  g.btw_meas = btw_meas;
  g.loop_meas = loop_meas;
  g.loop_weight = loop_weight;
  g.consts = consts;
  g.start = start;
  g.entries = entries;
  g.n = n;
  g.nb = nb;
  g.F = F;
  g.robust = robust;
  g.delta = delta;
  g.f64 = is_double != 0;
  return g;
}

bool valid(const Graph& g) {
  return g.n >= 1 && g.nb >= 0 && g.F >= g.nb && g.robust >= 0 &&
         g.robust <= 2 && (g.robust == 0 || g.delta > 0.0);
}

int blocks_for(long long threads) {
  return (int)((threads + K7_THREADS - 1) / K7_THREADS);
}

}  // namespace

#define K7_GRAPH_ARGS                                                      \
  const int *fi, const int *fj, const void *btw_meas, const void *loop_meas, \
      const void *loop_weight, const void *consts, const int *start,        \
      const int *entries, int n, int nb, int F, int robust, double delta
#define K7_GRAPH                                                           \
  make_graph(fi, fj, btw_meas, loop_meas, loop_weight, consts, start,      \
             entries, n, nb, F, robust, delta, is_double)

// (a): x (n, 3); out (9 (1 + 2 F) + 3 n) in x's dtype (float32: is_double
// 0, or float64); the graph as kernels/factors.FactorGraph holds it. One
// launch on `stream`; returns its CUDA error, or 0.
extern "C" int slam_factors_linearize(const void* x, K7_GRAPH_ARGS,
                                      int is_double, void* out,
                                      void* stream) {
  const Graph g = K7_GRAPH;
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  k7_linearize<<<blocks_for(n), K7_THREADS, 0, (cudaStream_t)stream>>>(
      x, g, out);
  return (int)cudaGetLastError();
}

// (b): grad (n, 3) and the blocks (a) wrote; lam a scalar; band poses a
// super-block (n_sup = ceil(n / band)); pad: the identity on the padded
// tail poses. A (n_sup, 3 band, 3 band), O (max(n_sup - 1, 1), ...),
// R (n_sup, 3 band, 1), each written whole. One launch on `stream`.
extern "C" int slam_factors_banded_system(
    const void* grad, K7_GRAPH_ARGS, int is_double, const void* Jp,
    const void* Jbi, const void* Jbj, const void* Jli, const void* Jlj,
    const void* lam, int band, int pad, void* A, void* O, void* R,
    void* stream) {
  const Graph g = K7_GRAPH;
  if (!valid(g) || band < 1) return (int)cudaErrorInvalidValue;
  const int n_sup = (n + band - 1) / band, n_o = n_sup > 1 ? n_sup - 1 : 1;
  const Blocks B = {Jp, Jbi, Jbj, Jli, Jlj};
  const long long threads = (long long)(n_sup + n_o) * band * band;
  k7_banded<<<blocks_for(threads), K7_THREADS, 0, (cudaStream_t)stream>>>(
      grad, g, B, lam, band, pad, n_sup, n_o, A, O, R);
  return (int)cudaGetLastError();
}

// (c): x (n, 3); out a scalar in x's dtype. One launch on `stream`.
extern "C" int slam_factors_cost(const void* x, K7_GRAPH_ARGS, int is_double,
                                 void* out, void* stream) {
  const Graph g = K7_GRAPH;
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  k7_cost<<<1, K7_COST_THREADS, 0, (cudaStream_t)stream>>>(x, g, out);
  return (int)cudaGetLastError();
}
