// 2D brute-force point location on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// gsl_scattered_interpolation_tpu/ops/pallas_locate.py::_kernel (:35-75).
// For query q (centred at the triangulation's shift) and triangle t:
//   c0 = (q.x * g0x[t] + q.y * g0y[t]) + b0[t]
//   c1 = (q.x * g1x[t] + q.y * g1y[t]) + b1[t]
//   score = min(min(c0, c1), (1 - c0) - c1)
// and the result is the index of the largest score, the lowest index on a
// tie.  Degenerate triangles carry a bias of -1e30 and never win.
//
// Bound.  Per (query, triangle) the work is 13 float32 instructions
// (4 mul, 4 add, 2 sub, 2 min, 1 compare) against 8 bytes read and 4
// written per query, so at T = 4,001 triangles it is instruction-bound:
// 13 * T * B / (132 SMs * 128 lanes * ~1.98 GHz), about 1.6 ms per
// million queries on an H100 SXM.
//
// Design.  One thread per query keeps the running (best score, best index)
// in registers.  The block stages the triangle table through shared memory
// in chunks of 1,024 triangles (24 KB) that every thread reads by
// broadcast, so device memory sees each query once and the table once per
// block.  The update is a strict '>' in ascending triangle order, which
// gives the first maximum, as torch.argmax and the TPU kernel's
// argmax-then-strict-'>' do.  Built with -fmad=false: each multiply and add
// rounds on its own, as in the eager PyTorch plain version, so the two
// agree leaf for leaf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kThreads)
locate2d_kernel(const float2* __restrict__ q, const float* __restrict__ g,
                const float* __restrict__ b, int n_q, int n_t,
                int* __restrict__ out) {
  __shared__ float4 s_g[kChunk];  // (g0x, g0y, g1x, g1y)
  __shared__ float2 s_b[kChunk];  // (b0, b1)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float2 qi = i < n_q ? q[i] : make_float2(0.f, 0.f);
  float best = -INFINITY;
  int best_idx = 0;
  for (int base = 0; base < n_t; base += kChunk) {
    const int n = min(kChunk, n_t - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int t = base + k;
      s_g[k] = make_float4(g[t], g[n_t + t], g[2 * n_t + t], g[3 * n_t + t]);
      s_b[k] = make_float2(b[t], b[n_t + t]);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 gk = s_g[k];
      const float2 bk = s_b[k];
      const float c0 = qi.x * gk.x + qi.y * gk.y + bk.x;
      const float c1 = qi.x * gk.z + qi.y * gk.w + bk.y;
      const float score = fminf(fminf(c0, c1), 1.0f - c0 - c1);
      if (score > best) {
        best = score;
        best_idx = base + k;
      }
    }
  }
  if (i < n_q) out[i] = best_idx;
}

}  // namespace

// q: [n_q, 2] float32, g: [4, n_t] float32 (rows g0x g0y g1x g1y),
// b: [2, n_t] float32 (rows b0 b1), out: [n_q] int32; all contiguous on
// the current device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int locate2d_launch(const void* q, const void* g, const void* b,
                               int n_q, int n_t, void* out, void* stream) {
  const int blocks = (n_q + kThreads - 1) / kThreads;
  locate2d_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(q), static_cast<const float*>(g),
      static_cast<const float*>(b), n_q, n_t, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
