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
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), so no FMA contraction
// happens: s.t = (sx*tx + sy*ty) + sz*tz and |t|^2 = (tx*tx + ty*ty) +
// tz*tz, each step rounded. kernels/nn.py::nn_argmin_rounded repeats this
// arithmetic op by op in PyTorch, and the kernel's indices equal it
// exactly. The plain version goes through a batched matmul whose rounding
// may differ in the last bit, so near-equidistant targets may resolve to
// different indices there. Pre-scaling the targets by -2 would save a
// multiply a pair, but it is not exact where a product is subnormal, so
// the kernel keeps 2 (s . t).
//
// What bounds it on an H100: at the gtsam path's chunk (64 pairs x 1,081
// sources x 1,081 targets) the operations: about 6 FP32 operations a
// pair, 0.45 GFLOP a call (6.7 us at 67 TFLOP/s), and about ten executed
// instructions a pair (3 multiplies, 2 adds, the doubling, the subtract,
// the compare and two selects). At the online path's B = 1 the work is
// 1/64 of that and latency bounds it: the staging load, a lane's chain of
// compares, the merge, and how many SMs the grid reaches.
//
// Design: a warp owns S consecutive source points of one pair (S = 1, 2
// or 4) and splits the targets across its lanes: lane l scans targets l,
// l + 32, l + 64, ... in increasing index with a strict '<' running
// minimum from (+inf, 0), for its S sources at once, so one shared-memory
// load of a target feeds S sources. A 5-step __shfl_xor_sync butterfly
// then merges the lanes under the lexicographic order on (d, j): the
// smaller d wins, and on an equal d the lower j. That is exactly the
// sequential scan's answer (the first index of the minimum; index 0 when
// no d is below +inf), including rows whose targets are all masked. A
// block of 8 warps stages the pair's targets once in shared memory as
// float4 (x, y, z, |t|^2), NN_STAGE at a time (an M beyond one stage loops
// over stages in index order). A masked target is staged as (0, 0, 0,
// 1e30): for a finite source its d is 1e30 - 2 (s . 0) = 1e30 exactly, the
// value the plain version replaces it with, and the loop has no test. The
// C entry picks S from B and N: the largest S that still gives every SM
// 16 warps. So the online path's B = 1 (N = 1,081) runs 1,081 one-source
// warps in 136 blocks on the 132 SMs, and the 64-pair chunk amortises
// every target load over 4 sources. It replaces a thread a source point
// scanning all M targets in order: 5 blocks at B = 1, each thread a
// 1,081-step dependent chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NN_WARPS = 8;
constexpr int NN_THREADS = 32 * NN_WARPS;
constexpr int NN_STAGE = 2048;  // targets a shared-memory stage (32 KB)
constexpr int NN_FILL = 16;     // warps each SM should get
constexpr float NN_BIG = 1e30f;
constexpr unsigned NN_ALL = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(NN_THREADS)
nn_argmin_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const uint8_t* __restrict__ mask, int N, int M, int D,
                 int32_t* __restrict__ idx_out, float* __restrict__ matched) {
  extern __shared__ float4 stage[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * NN_WARPS + (threadIdx.x >> 5)) * S;
  const bool active = i0 < N;  // warp-uniform

  float sx[S], sy[S], sz[S], best[S];
  int best_j[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* p = src + ((size_t)b * N + min(i0 + s, N - 1)) * D;
    sx[s] = p[0];
    sy[s] = p[1];
    sz[s] = (D == 3) ? p[2] : 0.f;
    best[s] = __int_as_float(0x7f800000);  // +inf
    best_j[s] = 0;
  }
  const float* tb = tgt + (size_t)b * M * D;
  const uint8_t* mb = mask + (size_t)b * M;

  for (int base = 0; base < M; base += NN_STAGE) {
    const int n = min(NN_STAGE, M - base);
    if (base > 0) __syncthreads();  // the previous stage is fully consumed
#pragma unroll 4
    for (int t = threadIdx.x; t < n; t += NN_THREADS) {
      const float* p = tb + (size_t)(base + t) * D;
      const float x = p[0], y = p[1], z = (D == 3) ? p[2] : 0.f;
      const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      stage[t] = mb[base + t] ? make_float4(x, y, z, t2)
                              : make_float4(0.f, 0.f, 0.f, NN_BIG);
    }
    __syncthreads();
    if (active) {
      for (int t = lane; t < n; t += 32) {
        const float4 q = stage[t];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(sx[s], q.x), __fmul_rn(sy[s], q.y)),
              __fmul_rn(sz[s], q.z));
          const float d = __fsub_rn(q.w, __fmul_rn(2.f, dot));
          if (d < best[s]) {
            best[s] = d;
            best_j[s] = base + t;
          }
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int s = 0; s < S; ++s) {
    float d = best[s];
    int j = best_j[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(NN_ALL, d, off);
      const int oj = __shfl_xor_sync(NN_ALL, j, off);
      if (od < d || (od == d && oj < j)) {
        d = od;
        j = oj;
      }
    }
    const int i = i0 + s;
    if (lane == s && i < N) {
      idx_out[(size_t)b * N + i] = j;
      const float* p = tb + (size_t)j * D;
      float* o = matched + ((size_t)b * N + i) * D;
      for (int k = 0; k < D; ++k) o[k] = p[k];
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int S>
void launch(const void* src, const void* tgt, const void* mask, int B, int N,
            int M, int D, void* idx, void* matched, cudaStream_t stream) {
  dim3 grid((N + S * NN_WARPS - 1) / (S * NN_WARPS), B);
  const size_t smem = sizeof(float4) * (size_t)min(M, NN_STAGE);
  nn_argmin_kernel<S><<<grid, NN_THREADS, smem, stream>>>(
      (const float*)src, (const float*)tgt, (const uint8_t*)mask, N, M, D,
      (int32_t*)idx, (float*)matched);
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
  // sources a warp: the largest S whose grid still gives every SM NN_FILL
  // warps
  const long fill = (long)NN_FILL * sm_count();
  int S = 4;
  while (S > 1 && (long)B * ((N + S - 1) / S) < fill) S /= 2;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S == 4) {
    launch<4>(src, tgt, mask, B, N, M, D, idx, matched, st);
  } else if (S == 2) {
    launch<2>(src, tgt, mask, B, N, M, D, idx, matched, st);
  } else {
    launch<1>(src, tgt, mask, B, N, M, D, idx, matched, st);
  }
  return (int)cudaGetLastError();
}
