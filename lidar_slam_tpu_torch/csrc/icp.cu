// icp_sweep_tail (K5): everything one sweep of planar point-to-point ICP
// does after K4's correspondence search, in one launch.
//
// Replaces no Pallas kernel. The JAX package runs the ICP loop as one
// lax.while_loop (lidar_slam_tpu/ops/icp.py) and XLA fuses the fit, the
// error and the stopping rules into the loop body. The port drives the
// loop from Python (ops/icp.py), where the same tail is about 65 small
// kernels a sweep (kabsch_planar, _error, _icp_body's rules) and the
// transform a few more, each launch costing the host far more than the
// device's work.
//
// For each pair b that is not done (a done pair is left as it is):
//   1. over the valid sources (src_mask), in one pass: the count n, the
//      sums of s and t (s the source under the previous transform, t its
//      matched target from K4), the raw 2 x 2 cross-moments sum s t^T,
//      sum |s - t|^2 in 3-D, and for the normalized error the masked min
//      and max of both clouds (exact);
//   2. thread 0: the planar Kabsch fit as ops/kabsch.kabsch_planar has it,
//      centroids c = sums / max(n, 1e-12), the centred moments
//      S = sum s t^T - n c_s c_t^T, theta = atan2f(S01 - S10, S00 + S11),
//      t = c_t - R c_s, composed as T_fit @ T_prev; the error at T_prev as
//      ops/icp._error has it (normalized: over the squared diagonal of
//      both clouds' joint box times max(n, 1)); _icp_body's stopping rules
//      (epsilon, max_iters, |last_err - err| < stopping_thresh, skipped
//      while last_err is +inf); the carry written in place: T, err,
//      last_err, last_err2, k, done;
//   3. the correspondences copied into the carry, and, for a pair still
//      live, its sources under the new transform: the next sweep's K4
//      input, so the transform is not a launch of its own.
//
// Precision: inputs and outputs are float32, as the configuration states.
// The sums are float64 in registers and shared memory (the product of two
// float32 values is exact in float64) and are rounded to float32 where
// kabsch_planar and _error hold float32 values; a warp's and the block's
// reduction run in a fixed order, so a result does not change from launch
// to launch. The transform and the 4 x 4 product are float32 FMA chains in
// the order of a K = 3 and K = 4 inner product. No fast-math intrinsics.
//
// What bounds it on an H100: latency. A source point costs 57 bytes:
// src_t, matched and the mask read in the first pass (25), src and idx in
// the second (16), src_t and idx written (16); at 64 pairs x 1,081 points
// that is 3.9 MB, 1.2 us at 3.35 TB/s, and about 20 float64 operations a
// point, 1.4 M, far under the card's rate. What takes the time is a
// chain of dependent steps a block: the first pass's loads, a warp's and
// then the block's reduction, thread 0's serial finish (atan2f, cosf,
// sinf, a 4 x 4 product), a barrier, the second pass.
//
// Why one block per pair: the fit needs every point of its pair, and a
// pair's points (1,081 here, a few thousand at most) fit one block's
// grid-stride loop, so the reduction, the finish and the update of the
// pair's sources stay in one launch with no second kernel and no atomics
// across blocks. The batches ICP runs are small (1 online, 8 in the
// relocalization polish, 64 in scan matching and loop closures): most of
// the 132 SMs sit idle for the few microseconds the launch takes, against
// the ~65 host launches it replaces.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr unsigned TAIL_ALL = 0xffffffffu;
// float64 sums: s_x, s_y, t_x, t_y, s_x t_x, s_x t_y, s_y t_x, s_y t_y,
// |s - t|^2
constexpr int TAIL_SUMS = 9;
// the box: min of s (x, y, z), max of s, min of t, max of t
constexpr int TAIL_BOX = 12;

__device__ __forceinline__ bool is_min_slot(int j) { return (j / 3) % 2 == 0; }

__global__ void __launch_bounds__(TAIL_THREADS)
icp_sweep_tail_kernel(const float* __restrict__ src, float* __restrict__ src_t,
                      const float* __restrict__ matched,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask, float* __restrict__ T,
                      float* __restrict__ err, float* __restrict__ last_err,
                      float* __restrict__ last_err2,
                      int32_t* __restrict__ idx_c, int32_t* __restrict__ k,
                      uint8_t* __restrict__ done, int N, int normalize,
                      float epsilon, int max_iters, float stopping_thresh) {
  const int b = blockIdx.x;
  if (done[b]) return;  // frozen; block-uniform

  __shared__ double red_sum[TAIL_WARPS][TAIL_SUMS];
  __shared__ float red_box[TAIL_WARPS][TAIL_BOX];
  __shared__ int red_n[TAIL_WARPS];
  __shared__ float Tn[12];  // rows 0-2 of the new transform
  __shared__ int stays_live;

  const size_t base = (size_t)b * N;
  const float inf = __int_as_float(0x7f800000);
  double acc[TAIL_SUMS];
  float box[TAIL_BOX];
#pragma unroll
  for (int j = 0; j < TAIL_SUMS; ++j) acc[j] = 0.0;
#pragma unroll
  for (int j = 0; j < TAIL_BOX; ++j) box[j] = is_min_slot(j) ? inf : -inf;
  int n = 0;

  // 1. one pass over the pair's valid sources
  for (int i = threadIdx.x; i < N; i += TAIL_THREADS) {
    if (!mask[base + i]) continue;
    const float* p = src_t + (base + i) * 3;
    const float* q = matched + (base + i) * 3;
    const float s[3] = {p[0], p[1], p[2]};
    const float t[3] = {q[0], q[1], q[2]};
    const float dx = s[0] - t[0], dy = s[1] - t[1], dz = s[2] - t[2];
    acc[0] += s[0];
    acc[1] += s[1];
    acc[2] += t[0];
    acc[3] += t[1];
    acc[4] += (double)s[0] * t[0];
    acc[5] += (double)s[0] * t[1];
    acc[6] += (double)s[1] * t[0];
    acc[7] += (double)s[1] * t[1];
    acc[8] += __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
    ++n;
    if (normalize) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        box[c] = fminf(box[c], s[c]);
        box[3 + c] = fmaxf(box[3 + c], s[c]);
        box[6 + c] = fminf(box[6 + c], t[c]);
        box[9 + c] = fmaxf(box[9 + c], t[c]);
      }
    }
  }

  // the warps' sums, then the block's, in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < TAIL_SUMS; ++j)
      acc[j] += __shfl_down_sync(TAIL_ALL, acc[j], off);
    n += __shfl_down_sync(TAIL_ALL, n, off);
    if (normalize) {
#pragma unroll
      for (int j = 0; j < TAIL_BOX; ++j) {
        const float o = __shfl_down_sync(TAIL_ALL, box[j], off);
        box[j] = is_min_slot(j) ? fminf(box[j], o) : fmaxf(box[j], o);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < TAIL_SUMS; ++j) red_sum[warp][j] = acc[j];
#pragma unroll
    for (int j = 0; j < TAIL_BOX; ++j) red_box[warp][j] = box[j];
    red_n[warp] = n;
  }
  __syncthreads();

  // 2. thread 0 fits, measures, applies the stopping rules and writes the
  // pair's carry
  if (threadIdx.x == 0) {
    double sum[TAIL_SUMS];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < TAIL_SUMS; ++j) sum[j] = 0.0;
#pragma unroll
    for (int j = 0; j < TAIL_BOX; ++j) box[j] = is_min_slot(j) ? inf : -inf;
    for (int w = 0; w < TAIL_WARPS; ++w) {
#pragma unroll
      for (int j = 0; j < TAIL_SUMS; ++j) sum[j] += red_sum[w][j];
#pragma unroll
      for (int j = 0; j < TAIL_BOX; ++j)
        box[j] = is_min_slot(j) ? fminf(box[j], red_box[w][j])
                                : fmaxf(box[j], red_box[w][j]);
      cnt += red_n[w];
    }
    const double nd = (double)cnt;
    const double wsum = fmax(nd, 1e-12);
    const double csx = sum[0] / wsum, csy = sum[1] / wsum;
    const double ctx = sum[2] / wsum, cty = sum[3] / wsum;
    const double S00 = sum[4] - nd * csx * ctx, S01 = sum[5] - nd * csx * cty;
    const double S10 = sum[6] - nd * csy * ctx, S11 = sum[7] - nd * csy * cty;
    const float theta = atan2f((float)(S01 - S10), (float)(S00 + S11));
    const float c = cosf(theta), s = sinf(theta);
    const float fcsx = (float)csx, fcsy = (float)csy;
    const float tx = (float)ctx - (c * fcsx - s * fcsy);
    const float ty = (float)cty - (s * fcsx + c * fcsy);
    const float F[16] = {c, -s, 0.f, tx, s, c, 0.f, ty,
                         0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 1.f};
    float* Tb = T + (size_t)b * 16;
    float P[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) P[j] = Tb[j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        float v = __fmul_rn(F[4 * r], P[col]);
#pragma unroll
        for (int m = 1; m < 4; ++m)
          v = __fmaf_rn(F[4 * r + m], P[4 * m + col], v);
        Tb[4 * r + col] = v;
        if (r < 3) Tn[4 * r + col] = v;
      }
    }

    float e = (float)sum[8];
    if (normalize) {
      float diag2 = 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float ext =
            fmaxf(box[3 + d], box[9 + d]) - fminf(box[d], box[6 + d]);
        diag2 = __fadd_rn(diag2, __fmul_rn(ext, ext));
      }
      e = e / (diag2 * (float)max(cnt, 1));
    }
    const float le = last_err[b];
    const bool stop = e < epsilon || k[b] >= max_iters ||
                      (!isinf(le) && fabsf(le - e) < stopping_thresh);
    err[b] = e;
    last_err2[b] = le;
    last_err[b] = e;
    k[b] += 1;
    done[b] = stop;
    stays_live = !stop;
  }
  __syncthreads();

  // 3. the correspondences, and the sources under the new transform
  const bool live = stays_live;
  for (int i = threadIdx.x; i < N; i += TAIL_THREADS) {
    idx_c[base + i] = idx[base + i];
    if (live) {
      const float* p = src + (base + i) * 3;
      const float x = p[0], y = p[1], z = p[2];
      float* o = src_t + (base + i) * 3;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float v = __fmaf_rn(z, Tn[4 * r + 2],
                                  __fmaf_rn(y, Tn[4 * r + 1],
                                            __fmul_rn(x, Tn[4 * r])));
        o[r] = __fadd_rn(v, Tn[4 * r + 3]);
      }
    }
  }
}

}  // namespace

// One sweep's tail for B pairs of N sources. Inputs: src (B, N, 3) float32
// sources, matched (B, N, 3) float32 and idx (B, N) int32 from K4 on
// src_t, src_mask (B, N) bool as bytes. The carry, updated in place:
// src_t (B, N, 3), T (B, 4, 4), err, last_err, last_err2 (B,) float32,
// idx_c (B, N) int32, k (B,) int32, done (B,) bool as bytes. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int slam_icp_sweep_tail(const void* src, void* src_t,
                                   const void* matched, const void* idx,
                                   const void* src_mask, void* T, void* err,
                                   void* last_err, void* last_err2,
                                   void* idx_c, void* k, void* done, int B,
                                   int N, int normalize, float epsilon,
                                   int max_iters, float stopping_thresh,
                                   void* stream) {
  if (B == 0) return 0;
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  icp_sweep_tail_kernel<<<B, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)src_t, (const float*)matched,
      (const int32_t*)idx, (const uint8_t*)src_mask, (float*)T, (float*)err,
      (float*)last_err, (float*)last_err2, (int32_t*)idx_c, (int32_t*)k,
      (uint8_t*)done, N, normalize, epsilon, max_iters, stopping_thresh);
  return (int)cudaGetLastError();
}
