// nn_argmin: masked brute-force nearest-neighbour search, fused with the
// row argmin and the gather of the matched target point.
//
// Replaces: lidar_slam_tpu/ops/pallas_nn.py::_nn_kernel / _nn_matched_kernel
// (launched by nearest_neighbors_pallas). Semantics are those of
// ops/nn.py::nearest_neighbors, not the Pallas kernel's packed-key
// truncation: for source point s and target t_j,
//     d_j = |t_j|^2 - 2 (s . t_j)          (|s|^2 omitted: constant per row)
// with masked targets REPLACED by 1e30, an exact argmin over j scanned
// upward with a strict '<' (the lowest index wins ties), and the matched
// output a bit-for-bit copy of tgt[idx].
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn), so no FMA contraction happens:
// s.t = (sx*tx + sy*ty) + sz*tz and |t|^2 = (tx*tx + ty*ty) + tz*tz, each
// step rounded. The plain PyTorch version goes through a batched matmul
// whose rounding may differ in the last bit, so near-equidistant targets
// may resolve to different indices; callers compare the chosen
// neighbours' distances, not raw indices.
//
// What bounds it on an H100: compute. Each (source, target) pair costs
// about 6 FP32 operations (3 multiplies, 2 adds, 1 compare-select); at the
// main path's chunk (64 pairs x 1,081 sources x 1,081 targets) that is
// ~0.45 GFLOP per call against 4 x 1,081 x 64 x 4 B (~1.1 MB) of input.
// The plain version instead writes and reads a (64, 1081, 1081) float32
// distance tensor (~300 MB) per ICP iteration.
//
// Design: grid (ceil(N / 256), B), one thread per source point. The
// block stages the pair's targets as float4 (x, y, z, |t|^2, or -1 for a
// masked target) in shared memory, NN_TILE targets per stage (16 KB), and
// every thread scans the stage from shared memory. M has no cap: larger
// target sets loop over stages in index order, which keeps the
// lowest-index tie rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NN_THREADS = 256;
constexpr int NN_TILE = 1024;
constexpr float NN_BIG = 1e30f;

__global__ void __launch_bounds__(NN_THREADS)
nn_argmin_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const uint8_t* __restrict__ mask, int N, int M, int D,
                 int32_t* __restrict__ idx_out, float* __restrict__ matched) {
  __shared__ float4 stage[NN_TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * NN_THREADS + threadIdx.x;
  const bool active = i < N;

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (active) {
    const float* s = src + ((size_t)b * N + i) * D;
    sx = s[0];
    sy = s[1];
    if (D == 3) sz = s[2];
  }
  const float* tb = tgt + (size_t)b * M * D;
  const uint8_t* mb = mask + (size_t)b * M;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int base = 0; base < M; base += NN_TILE) {
    const int n = min(NN_TILE, M - base);
    __syncthreads();  // the previous stage is fully consumed
    for (int t = threadIdx.x; t < n; t += NN_THREADS) {
      const float* p = tb + (size_t)(base + t) * D;
      const float x = p[0], y = p[1], z = (D == 3) ? p[2] : 0.f;
      const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      // w < 0 flags a masked target (a valid |t|^2 is never negative)
      stage[t] = make_float4(x, y, z, mb[base + t] ? t2 : -1.f);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < n; ++t) {
        const float4 q = stage[t];
        float d;
        if (q.w < 0.f) {
          d = NN_BIG;  // masked: replaced, not added
        } else {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(sx, q.x), __fmul_rn(sy, q.y)),
              __fmul_rn(sz, q.z));
          d = __fsub_rn(q.w, __fmul_rn(2.f, dot));
        }
        if (d < best) {
          best = d;
          best_j = base + t;
        }
      }
    }
  }
  if (active) {
    idx_out[(size_t)b * N + i] = best_j;
    const float* p = tb + (size_t)best_j * D;
    float* o = matched + ((size_t)b * N + i) * D;
    for (int k = 0; k < D; ++k) o[k] = p[k];
  }
}

}  // namespace

// src (B, N, D), tgt (B, M, D) float32; mask (B, M) bool as bytes;
// outputs idx (B, N) int32 and matched (B, N, D) float32. D is 2 or 3.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int slam_nn_argmin(const void* src, const void* tgt,
                              const void* mask, int B, int N, int M, int D,
                              void* idx, void* matched, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (M <= 0 || (D != 2 && D != 3)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + NN_THREADS - 1) / NN_THREADS, B);
  nn_argmin_kernel<<<grid, NN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)tgt, (const uint8_t*)mask, N, M, D,
      (int32_t*)idx, (float*)matched);
  return (int)cudaGetLastError();
}
