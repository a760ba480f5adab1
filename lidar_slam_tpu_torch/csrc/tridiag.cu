// block_tridiag (K6): the pose graph's SPD block-tridiagonal solve
// T X = R by SPIKE, in three launches with no host read.
//
// Replaces no Pallas kernel. The JAX package runs this solve
// (lidar_slam_tpu/models/pose_graph.py::block_tridiag_solve) as lax.scans
// that XLA compiles into one program. The port's op-by-op version
// (models/pose_graph.py) walks the same recurrences from Python: at the
// offline cells' shape (496 blocks of 30 x 30, m = 1, q = 32) about 740
// torch operations a solve, 47 of them torch.linalg.inv, each of which
// reads its error flag back to the host.
//
// The decomposition is models/pose_graph.block_tridiag_solve's, with the
// same q. A chain of n > 2q blocks splits into B = ceil(n/q) segments of q
// (the last padded with identity blocks, read as such, never stored); a
// chain of n <= 2q blocks is one segment of q = n. Launches:
//   (a) k6_segments, one block a segment: block Thomas over its q-1
//       interior blocks against the panel [R | E_f | E_l] (M = m + 2b
//       columns; E_f and E_l the identity at the first and last interior
//       block, the two spikes), forward then backward, the panel and its
//       solution Y kept in the scratch buffer; then the segment's terms of
//       the reduced interface system: its own interface block's
//       A - Rc Yl Rc^T and R - Rc YR, and the terms it adds to the previous
//       segment's interface (-Lc^T Yf Lc, -Lc^T YR, the coupling
//       -Rc Yf Lc);
//   (b) k6_interface, one block: block Thomas over the B interface blocks,
//       writing their x;
//   (c) k6_interiors, one block a segment: x = YR - Yf (Lc x_prev) -
//       Yl (Rc^T x_own) at every interior block, all at once.
// A Thomas step j: L_j = O_{j-1} G_{j-1}; G_j = (A_j - L_j O_{j-1}^T)^-1;
// z_j = P_j - L_j z_{j-1}; backward x_j = G_j z_j - L_{j+1}^T x_{j+1}.
//
// Precision: A, O, R and X are float32 or float64 (the LM's dtype); every
// operation inside is float64. The diagonal blocks are symmetric positive
// definite (J^T J + lam I and its Schur complements), so each is inverted
// by Gauss-Jordan elimination without pivoting: every pivot is a positive
// Schur complement, the one a Cholesky factorization would take.
//
// What bounds it on an H100: its sequential depth, not its work. At the
// cells' shape the chain is 2 (q + n/q) = 96 dependent block steps (31
// forward and 31 backward in (a), 16 and 16 in (b)), a forward step a few
// barrier phases and b elimination steps. The work is about 0.25 GFLOP in
// float64 and the bytes about 3.7 MB (the scratch panels stay in the 50 MB
// L2), microseconds at the card's rates.
//
// How a step stays inside one block (b <= 32, 1,024 threads): the step's
// b x b operands (G_{j-1}, L_j, O_{j-1}, D) sit in shared memory, five
// tiles of 42 KB. The inversion is the step's sequential core: b
// elimination steps, thread (r, k) holding entry (r, k) in a register, so
// a step is three broadcast reads of the pivot row, column and reciprocal,
// a multiply-add and one barrier; the next pivot's reciprocal is taken by
// its own thread in the step before, by the hardware's approximate
// reciprocal and two Newton steps (half a division's latency). The two
// b x b products take 2 x 2 entries a thread, which halves their
// shared-memory reads, the products' limit; while the second one runs, the
// other threads update the panel (four rows of a column a thread) and load
// the next step's coupling. The panel (b x M entries, any M) lives in the
// scratch buffer; a step reads the previous step's, which the barrier
// makes visible within the block. The backward sweep loads each step's G
// and L while the step before computes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K6_MAX_B = 32;  // widest block: a shared-memory tile's side
constexpr int K6_THREADS = K6_MAX_B * K6_MAX_B;  // a thread a block entry
constexpr int K6_PR = 2, K6_PC = 2;  // a product's entries a thread
constexpr int K6_PRODUCT =           // threads of a product
    (K6_MAX_B / K6_PR) * (K6_MAX_B / K6_PC);
constexpr int K6_ROWS = 4;  // panel rows a thread

// A b x b block in shared memory; the pad column spreads a warp's reads
// down a column over the banks.
typedef double Tile[K6_MAX_B][K6_MAX_B + 1];

// The pivot row and column of a Gauss-Jordan step and the pivot's
// reciprocal, double-buffered by the step's parity.
struct Pivots {
  double row[2][K6_MAX_B], col[2][K6_MAX_B], rcp[2];
};

struct Chain {
  int n, b, m, q;  // blocks, block width, rhs columns, segment length
  int B, qi, M;    // segments, interior blocks a segment, panel columns
  bool f64;        // A, O, R and X float64, else float32
};

Chain make_chain(int n, int b, int m, int q, bool f64) {
  Chain c;
  c.n = n;
  c.b = b;
  c.m = m;
  c.q = q;
  c.B = (n + q - 1) / q;
  c.qi = q - 1;
  c.M = m + 2 * b;
  c.f64 = f64;
  return c;
}

// Entry i of an input or output array in the chain's dtype. One kernel
// serves both dtypes (a block-uniform branch a load), which halves the
// source's build time against a template instantiated twice.
__device__ __forceinline__ double load(const void* p, size_t i,
                                       const Chain& c) {
  return c.f64 ? ((const double*)p)[i] : (double)((const float*)p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, double v,
                                      const Chain& c) {
  if (c.f64)
    ((double*)p)[i] = v;
  else
    ((float*)p)[i] = (float)v;
}

// The scratch buffer, float64: the interior panels and solutions, the
// Thomas multipliers and inverses of (a) and (b), the interface terms.
struct Scratch {
  double *Z, *Y;            // B x qi x b x M
  double *L, *G;            // B x qi x b x b
  double *ownA, *leftA, *leftO, *Lh, *Gh;  // B x b x b
  double *ownR, *leftR, *Zh, *Xh, *U, *V;  // B x b x m
};

// Points w's arrays into the buffer at base (null: only counts); returns
// the buffer's float64 entries.
size_t carve(const Chain& c, double* base, Scratch* w) {
  const size_t panel = (size_t)c.B * c.qi * c.b * c.M;
  const size_t steps = (size_t)c.B * c.qi * c.b * c.b;
  const size_t bb = (size_t)c.B * c.b * c.b, bm = (size_t)c.B * c.b * c.m;
  double** order[] = {&w->Z, &w->Y, &w->L, &w->G, &w->ownA, &w->leftA,
                      &w->leftO, &w->Lh, &w->Gh, &w->ownR, &w->leftR,
                      &w->Zh, &w->Xh, &w->U, &w->V};
  const size_t sizes[] = {panel, panel, steps, steps, bb, bb, bb, bb, bb,
                          bm, bm, bm, bm, bm, bm};
  size_t off = 0;
  for (int i = 0; i < 15; ++i) {
    *order[i] = base ? base + off : nullptr;
    off += sizes[i];
  }
  return off;
}

// Blocks of the padded chain: identity diagonal, zero coupling and rhs
// past the end.
__device__ __forceinline__ double a_at(const void* A, const Chain& c, int g,
                                       int r, int k) {
  return g < c.n ? load(A, ((size_t)g * c.b + r) * c.b + k, c)
                 : (r == k ? 1.0 : 0.0);
}

// T[g + 1, g]
__device__ __forceinline__ double o_at(const void* O, const Chain& c, int g,
                                       int r, int k) {
  return (g >= 0 && g < c.n - 1) ? load(O, ((size_t)g * c.b + r) * c.b + k, c)
                                 : 0.0;
}

__device__ __forceinline__ double r_at(const void* R, const Chain& c, int g,
                                       int r, int k) {
  return g < c.n ? load(R, ((size_t)g * c.b + r) * c.m + k, c) : 0.0;
}

// Interior block j's panel [R | E_f | E_l], entry (r, k)
__device__ __forceinline__ double panel_at(const void* R, const Chain& c,
                                           int g, int j, int r, int k) {
  if (k < c.m) return r_at(R, c, g, r, k);
  k -= c.m;
  if (k < c.b) return (j == 0 && k == r) ? 1.0 : 0.0;
  k -= c.b;
  return (j == c.qi - 1 && k == r) ? 1.0 : 0.0;
}

// C = X Y (or X Y^T with YT) for b x b tiles: the first K6_PRODUCT
// threads take 2 x 2 entries each, rows r0.. and columns k0.. (a
// register block that cuts the shared-memory reads that bound a
// product); returns whether the thread has any. Rows and columns past b
// read the tiles' unused entries and are not to be stored.
template <bool YT>
__device__ bool product(const Tile& X, const Tile& Y, int b,
                        double c[K6_PR][K6_PC], int& r0, int& k0) {
  const int t = threadIdx.x;
  r0 = K6_PR * (t / (K6_MAX_B / K6_PC));
  k0 = K6_PC * (t % (K6_MAX_B / K6_PC));
  if (t >= K6_PRODUCT || r0 >= b || k0 >= b) return false;
#pragma unroll
  for (int q = 0; q < K6_PR; ++q)
#pragma unroll
    for (int u = 0; u < K6_PC; ++u) c[q][u] = 0.0;
  for (int i = 0; i < b; ++i) {
    double x[K6_PR], y[K6_PC];
#pragma unroll
    for (int q = 0; q < K6_PR; ++q) x[q] = X[r0 + q][i];
#pragma unroll
    for (int u = 0; u < K6_PC; ++u) y[u] = YT ? Y[k0 + u][i] : Y[i][k0 + u];
#pragma unroll
    for (int q = 0; q < K6_PR; ++q)
#pragma unroll
      for (int u = 0; u < K6_PC; ++u) c[q][u] = fma(x[q], y[u], c[q][u]);
  }
  return true;
}

// 1 / a for a normal double: the hardware's approximate reciprocal and
// two Newton steps, each doubling its bits, to within an ulp of the
// correctly rounded quotient, in about half the latency of a division (an
// elimination step waits for it).
__device__ __forceinline__ double reciprocal(double a) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(a));
  r = fma(r, fma(-a, r, 1.0), r);
  return fma(r, fma(-a, r, 1.0), r);
}

// Entry (r, k) of the block to invert, into tile d, and into the first
// Gauss-Jordan step's pivot row, column and reciprocal.
__device__ __forceinline__ void put_d(Tile& d, Pivots& pv, int r, int k,
                                      double v) {
  d[r][k] = v;
  if (r == 0) pv.row[0][k] = v;
  if (k == 0) pv.col[0][r] = v;
  if (r == 0 && k == 0) pv.rcp[0] = reciprocal(v);
}

// The inverse of the b x b block d (its first pivot published by put_d)
// by Gauss-Jordan elimination without pivoting, into g and g_out (b x b,
// row-major); every thread of the block calls it. Warp r holds row r,
// lane k entry (r, k), in a register. Step p: d_rk - d_rp (d_pk / d_pp),
// row p scaled by 1 / d_pp, column p -d_rp / d_pp, the pivot 1 / d_pp;
// then row and column p + 1 are published, and the next pivot's
// reciprocal by its own thread, for the next step: one barrier a step.
__device__ void gj_inverse(const Tile& d, Tile& g, double* g_out, int b,
                           Pivots& pv) {
  const int r = threadIdx.x / K6_MAX_B, k = threadIdx.x % K6_MAX_B;
  double a = r < b && k < b ? d[r][k] : 0.0;
  for (int p = 0; p < b; ++p) {
    const int cur = p & 1, nxt = cur ^ 1;
    if (r < b) {  // warp-uniform, as are the tests of r below
      const double rp = pv.rcp[cur], pk = pv.row[cur][k] * rp;
      const double cr = pv.col[cur][r];
      if (r == p)
        a = k == p ? rp : pk;
      else
        a = k == p ? -cr * rp : fma(-cr, pk, a);
      if (k == p + 1) pv.col[nxt][r] = a;
      if (r == p + 1) {
        pv.row[nxt][k] = a;
        if (k == p + 1) pv.rcp[nxt] = reciprocal(a);
      }
    }
    __syncthreads();
  }
  if (r < b && k < b) {
    g[r][k] = a;
    g_out[r * b + k] = a;
  }
}

// One forward Thomas step. Tiles: 0 G_{j-1}, 1 L_j, 2 + (j & 1) O_{j-1}
// (loaded by the step before), 4 D. With `coupled`: L = O G (also to
// Lout); then D = A - L O^T while the other threads update the panel,
// z = P - L z_prev over `cols` columns, and load the next step's coupling
// O_next into the other O tile; then G = D^-1 (tile 0 and Gout). A_fn,
// P_fn and O_next give the entries of the step's diagonal block, panel and
// next coupling; the product's threads read their entries of A before the
// first product, so that the load hides behind it.
template <typename AF, typename PF, typename OF>
__device__ void thomas_forward(Tile* sm, Pivots& pv, int j, bool coupled,
                               int b, int cols, AF A_fn, PF P_fn, OF O_next,
                               bool has_next, const double* z_prev, double* z,
                               double* Lout, double* Gout) {
  Tile &sG = sm[0], &sL = sm[1], &sO = sm[2 + (j & 1)], &sD = sm[4];
  const int t = threadIdx.x;
  double c[K6_PR][K6_PC], av[K6_PR][K6_PC];
  int r0, k0;
  if (coupled) {
    r0 = K6_PR * (t / (K6_MAX_B / K6_PC));
    k0 = K6_PC * (t % (K6_MAX_B / K6_PC));
    if (t < K6_PRODUCT && r0 < b && k0 < b) {
#pragma unroll
      for (int q = 0; q < K6_PR; ++q)
#pragma unroll
        for (int u = 0; u < K6_PC; ++u)
          av[q][u] = r0 + q < b && k0 + u < b ? A_fn(r0 + q, k0 + u) : 0.0;
    }
    if (product<false>(sO, sG, b, c, r0, k0)) {
#pragma unroll
      for (int q = 0; q < K6_PR; ++q)
#pragma unroll
        for (int u = 0; u < K6_PC; ++u)
          if (r0 + q < b && k0 + u < b) {
            sL[r0 + q][k0 + u] = c[q][u];
            Lout[(r0 + q) * b + k0 + u] = c[q][u];
          }
    }
    __syncthreads();
  }
  if (t < K6_PRODUCT) {
    if (!coupled) {
      for (int e = t; e < b * b; e += K6_PRODUCT)
        put_d(sD, pv, e / b, e % b, A_fn(e / b, e % b));
    } else if (product<true>(sL, sO, b, c, r0, k0)) {
#pragma unroll
      for (int q = 0; q < K6_PR; ++q)
#pragma unroll
        for (int u = 0; u < K6_PC; ++u)
          if (r0 + q < b && k0 + u < b)
            put_d(sD, pv, r0 + q, k0 + u, av[q][u] - c[q][u]);
    }
  } else {
    const int u0 = t - K6_PRODUCT, nu = K6_THREADS - K6_PRODUCT;
    const int groups = (b + K6_ROWS - 1) / K6_ROWS;
    for (int u = u0; u < groups * cols; u += nu) {
      const int rr = (u / cols) * K6_ROWS, cc = u % cols;
      double v[K6_ROWS];
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q)
        v[q] = rr + q < b ? P_fn(rr + q, cc) : 0.0;
      if (coupled)
        for (int i = 0; i < b; ++i) {
          const double zi = z_prev[i * cols + cc];
#pragma unroll
          for (int q = 0; q < K6_ROWS; ++q)
            v[q] = fma(-sL[rr + q][i], zi, v[q]);
        }
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q)
        if (rr + q < b) z[(rr + q) * cols + cc] = v[q];
    }
    if (has_next) {
      Tile& sOn = sm[2 + ((j + 1) & 1)];
      for (int e = u0; e < b * b; e += nu)
        sOn[e / b][e % b] = O_next(e / b, e % b);
    }
  }
  __syncthreads();
  gj_inverse(sD, sG, Gout, b, pv);
  __syncthreads();
}

// The backward sweep over `steps` blocks: x_j = G_j z_j - L_{j+1}^T x_{j+1}
// (the second term absent at the last block), G_j and L_j (b x b, L_0
// unused) from G and L, z_j and x_j (b x cols) in Z and X, each j-major.
// Tiles 0-1 and 2-3 double-buffer G_j and L_{j+1}: each step loads the
// next step's pair while it computes. A thread takes K6_ROWS rows of a
// column. on_x(j, e, x) sees every entry.
template <typename WF>
__device__ void thomas_backward(Tile* sm, int b, int cols, int steps,
                                const double* G, const double* L,
                                const double* Z, double* X, WF on_x) {
  const int t = threadIdx.x, bb = b * b;
  const size_t bc = (size_t)b * cols;
  const int groups = (b + K6_ROWS - 1) / K6_ROWS;
  for (int e = t; e < bb; e += K6_THREADS)
    sm[0][e / b][e % b] = G[(size_t)(steps - 1) * bb + e];
  __syncthreads();
  for (int j = steps - 1; j >= 0; --j) {
    const int cur = (steps - 1 - j) & 1;
    if (j > 0)
      for (int e = t; e < bb; e += K6_THREADS) {
        const int r = e / b, k = e - r * b;
        sm[cur ^ 1][r][k] = G[(size_t)(j - 1) * bb + e];
        sm[2 + (cur ^ 1)][r][k] = L[(size_t)j * bb + e];
      }
    const Tile &sG = sm[cur], &sL = sm[2 + cur];
    const double* z = Z + j * bc;
    const double* xn = X + (j + 1) * bc;
    double* x = X + j * bc;
    const bool last = j + 1 == steps;
    for (int u = t; u < groups * cols; u += K6_THREADS) {
      const int r0 = (u / cols) * K6_ROWS, cc = u % cols;
      double v[K6_ROWS] = {};
      for (int i = 0; i < b; ++i) {
        const double zi = z[i * cols + cc];
#pragma unroll
        for (int q = 0; q < K6_ROWS; ++q) v[q] = fma(sG[r0 + q][i], zi, v[q]);
      }
      if (!last)
        for (int i = 0; i < b; ++i) {
          const double xi = xn[i * cols + cc];
#pragma unroll
          for (int q = 0; q < K6_ROWS; ++q)
            v[q] = fma(-sL[i][r0 + q], xi, v[q]);
        }
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q)
        if (r0 + q < b) {
          const int e = (r0 + q) * cols + cc;
          x[e] = v[q];
          on_x(j, e, v[q]);
        }
    }
    __syncthreads();
  }
}

// Rc (the last interior block's coupling to the segment's interface) into
// tile 2, Lc (the previous segment's interface's coupling to the first
// interior block; zero for segment 0) into tile 1.
__device__ void load_couplings(Tile* sm, const void* O, const Chain& c,
                               int s) {
  const int g0 = s * c.q, gi = g0 + c.qi, b = c.b;
  for (int e = threadIdx.x; e < b * b; e += K6_THREADS) {
    const int r = e / b, k = e - r * b;
    sm[2][r][k] = o_at(O, c, gi - 1, r, k);
    sm[1][r][k] = s > 0 ? o_at(O, c, g0 - 1, r, k) : 0.0;
  }
  __syncthreads();
}

// (a) one block a segment
__global__ void __launch_bounds__(K6_THREADS)
k6_segments(const void* __restrict__ A, const void* __restrict__ O,
            const void* __restrict__ R, Scratch w, Chain c) {
  __shared__ Tile sm[5];
  __shared__ Pivots pv;
  const int s = blockIdx.x, t = threadIdx.x;
  const int b = c.b, m = c.m, M = c.M, qi = c.qi, g0 = s * c.q, bb = b * b;
  const size_t bM = (size_t)b * M;
  double* Z = w.Z + (size_t)s * qi * bM;
  double* Y = w.Y + (size_t)s * qi * bM;
  double* Ls = w.L + (size_t)s * qi * bb;
  double* Gs = w.G + (size_t)s * qi * bb;

  for (int j = 0; j < qi; ++j) {
    const int g = g0 + j;
    thomas_forward(
        sm, pv, j, j > 0, b, M,
        [&](int r, int k) { return a_at(A, c, g, r, k); },
        [&](int r, int k) { return panel_at(R, c, g, j, r, k); },
        [&](int r, int k) { return o_at(O, c, g, r, k); }, j + 1 < qi,
        j > 0 ? Z + (j - 1) * bM : nullptr, Z + j * bM, Ls + j * bb,
        Gs + j * bb);
  }
  if (qi > 0)
    thomas_backward(sm, b, M, qi, Gs, Ls, Z, Y, [](int, int, double) {});

  // the segment's terms of the interface system: with Lc in tile 1 and Rc
  // in tile 2, Yl Rc^T, Yf[0] Lc and Yf[qi-1] Lc into tiles 3, 4 and 0
  load_couplings(sm, O, c, s);
  Tile &sL = sm[1], &sO = sm[2];
  for (int e = t; e < bb; e += K6_THREADS) {
    const int r = e / b, k = e - r * b;
    double t1 = 0.0, t2 = 0.0, t3 = 0.0;
    if (qi > 0) {
      const double* yl = Y + (qi - 1) * bM + r * M + m;  // row r of Yf, Yl
      const double* yf = Y + r * M + m;                   // at block 0
      for (int i = 0; i < b; ++i) {
        t1 = fma(yl[b + i], sO[k][i], t1);
        t2 = fma(yf[i], sL[i][k], t2);
        t3 = fma(yl[i], sL[i][k], t3);
      }
    }
    sm[3][r][k] = t1;
    sm[4][r][k] = t2;
    sm[0][r][k] = t3;
  }
  __syncthreads();
  for (int e = t; e < bb; e += K6_THREADS) {
    const int r = e / b, k = e - r * b;
    double a = a_at(A, c, g0 + qi, r, k), la = 0.0, lo = 0.0;
    for (int i = 0; i < b; ++i) {
      a = fma(-sO[r][i], sm[3][i][k], a);
      la = fma(-sL[i][r], sm[4][i][k], la);
      lo = fma(-sO[r][i], sm[0][i][k], lo);
    }
    const size_t at = (size_t)s * bb + e;
    w.ownA[at] = a;
    w.leftA[at] = la;
    w.leftO[at] = lo;
  }
  const int bm = b * m;
  for (int e = t; e < bm; e += K6_THREADS) {
    const int rr = e / m, cc = e - rr * m;
    double v = r_at(R, c, g0 + qi, rr, cc), lv = 0.0;
    if (qi > 0) {
      const double* yl = Y + (qi - 1) * bM + cc;  // YR at the last block
      const double* yf = Y + cc;                  // and at block 0
      for (int i = 0; i < b; ++i) {
        v = fma(-sO[rr][i], yl[i * M], v);
        lv = fma(-sL[i][rr], yf[i * M], lv);
      }
    }
    w.ownR[(size_t)s * bm + e] = v;
    w.leftR[(size_t)s * bm + e] = lv;
  }
}

// (b) one block: Thomas over the interface blocks, their x into X
__global__ void __launch_bounds__(K6_THREADS)
k6_interface(void* __restrict__ X, Scratch w, Chain c) {
  __shared__ Tile sm[5];
  __shared__ Pivots pv;
  const int b = c.b, m = c.m, B = c.B;
  const size_t bb = (size_t)b * b, bm = (size_t)b * m;
  for (int s = 0; s < B; ++s) {
    const bool next = s + 1 < B;
    thomas_forward(
        sm, pv, s, s > 0, b, m,
        [&](int r, int k) {
          return w.ownA[s * bb + r * b + k] +
                 (next ? w.leftA[(s + 1) * bb + r * b + k] : 0.0);
        },
        [&](int r, int k) {
          return w.ownR[s * bm + r * m + k] +
                 (next ? w.leftR[(s + 1) * bm + r * m + k] : 0.0);
        },
        [&](int r, int k) { return w.leftO[(s + 1) * bb + r * b + k]; },
        next, s > 0 ? w.Zh + (s - 1) * bm : nullptr, w.Zh + s * bm,
        w.Lh + s * bb, w.Gh + s * bb);
  }
  thomas_backward(sm, b, m, B, w.Gh, w.Lh, w.Zh, w.Xh,
                  [&](int s, int e, double x) {
                    const int gi = s * c.q + c.qi;
                    if (gi < c.n) store(X, (size_t)gi * bm + e, x, c);
                  });
}

// (c) one block a segment: the interior blocks' x
__global__ void __launch_bounds__(K6_THREADS)
k6_interiors(const void* __restrict__ O, void* __restrict__ X, Scratch w,
             Chain c) {
  __shared__ Tile sm[5];
  const int s = blockIdx.x, t = threadIdx.x;
  const int b = c.b, m = c.m, M = c.M, qi = c.qi, g0 = s * c.q;
  if (qi == 0) return;  // block-uniform
  load_couplings(sm, O, c, s);
  Tile &sL = sm[1], &sO = sm[2];  // Lc, Rc
  const int bm = b * m;
  double* U = w.U + (size_t)s * bm;  // Lc x^[s-1]
  double* V = w.V + (size_t)s * bm;  // Rc^T x^[s]
  const double* xp = w.Xh + (size_t)(s > 0 ? s - 1 : 0) * bm;
  const double* xs = w.Xh + (size_t)s * bm;
  for (int e = t; e < bm; e += K6_THREADS) {
    const int rr = e / m, cc = e - rr * m;
    double u = 0.0, v = 0.0;
    for (int i = 0; i < b; ++i) {
      if (s > 0) u = fma(sL[rr][i], xp[i * m + cc], u);
      v = fma(sO[i][rr], xs[i * m + cc], v);
    }
    U[e] = u;
    V[e] = v;
  }
  __syncthreads();
  const double* Y = w.Y + (size_t)s * qi * b * M;
  const int n_el = qi * bm;
  for (int e = t; e < n_el; e += K6_THREADS) {
    const int j = e / bm, rem = e - j * bm;
    const int rr = rem / m, cc = rem - rr * m;
    const int g = g0 + j;
    if (g >= c.n) continue;
    const double* y = Y + ((size_t)j * b + rr) * M;
    double x = y[cc];
    for (int i = 0; i < b; ++i) x = fma(-y[m + i], U[i * m + cc], x);
    for (int i = 0; i < b; ++i) x = fma(-y[m + b + i], V[i * m + cc], x);
    store(X, (size_t)g * bm + rem, x, c);
  }
}

int launch(const void* A, const void* O, const void* R, void* X,
           const Scratch& w, const Chain& c, cudaStream_t stream) {
  k6_segments<<<c.B, K6_THREADS, 0, stream>>>(A, O, R, w, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k6_interface<<<1, K6_THREADS, 0, stream>>>(X, w, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k6_interiors<<<c.B, K6_THREADS, 0, stream>>>(O, X, w, c);
  return (int)cudaGetLastError();
}

}  // namespace

// float64 scratch entries block_tridiag needs for n blocks of b x b, m
// rhs columns and segments of q blocks (q = n for one segment).
extern "C" long long slam_block_tridiag_scratch(int n, int b, int m, int q) {
  if (n < 1 || b < 1 || m < 1 || q < 1) return 0;
  Scratch w;
  return (long long)carve(make_chain(n, b, m, q, false), nullptr, &w);
}

// T X = R for SPD block-tridiagonal T: A (n, b, b), O (n-1, b, b) with
// O_i = T[i+1, i], R and X (n, b, m), float32 (is_double 0) or float64,
// contiguous; segments of q blocks (2 <= q < n, or q = n for one
// segment); 1 <= b <= 32; scratch of at least slam_block_tridiag_scratch
// float64 entries. Three launches on `stream`; returns the first launch's
// CUDA error, or 0.
extern "C" int slam_block_tridiag(const void* A, const void* O,
                                  const void* R, void* X, void* scratch,
                                  long long scratch_len, int n, int b, int m,
                                  int q, int is_double, void* stream) {
  if (n < 1 || b < 1 || b > K6_MAX_B || m < 1 || q < 1 || q > n ||
      (q < 2 && n > 1))
    return (int)cudaErrorInvalidValue;
  const Chain c = make_chain(n, b, m, q, is_double != 0);
  Scratch w;
  if ((long long)carve(c, (double*)scratch, &w) > scratch_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return launch(A, O, R, X, w, c, st);
}
