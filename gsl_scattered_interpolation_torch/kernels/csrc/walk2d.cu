// The 2D cell route's walk fallback on Hopper (sm_90a): each walked query
// steps to its end in one launch.
//
// Replaces no Pallas kernel: the JAX package walks every query in lockstep
// inside one lax.while_loop of XLA ops (gsl_scattered_interpolation_tpu/
// models/device_tri.py::locate), and the port's plain version is the same
// loop in torch (models/device_tri.py::locate), a dozen small launches a
// step and a host read of `done` every WALK_DONE_EVERY steps.  Each query's
// path depends on its own state alone, so one thread walks it to its end.
//
// For walked query i (row idx[i] of the batch, raw coordinates q):
//   start: cell = clamp(floor((scale * (q - shift) + 0.5) * G), 0, G - 1),
//          cur = hint[cx * G + cy], prev = -1
//   step s = 0, 1, ..., max_steps - 1:
//     w = the weights of cur from its [T, 8] affine row (A00 A01 A10 A11 ax
//         ay w00 w01) in device_tri._weights' order (cells2d.cu's epilogue)
//     worst = argmin(w), torch's order: NaN below every number, the lowest
//         face on a tie; on odd s, where more than one weight is below -tol,
//         the argmin with w[worst] set to +inf instead
//     inside = every w >= -tol, nbr = nbrs[cur][worst]
//     stop if inside, if nbr < 0 (outside: a boundary face) or if nbr ==
//         prev (a 2-cycle); else prev = cur, cur = nbr
//   in_domain = !outside && (every w >= -tol || stopped) && every w > -0.5,
//   with w the final simplex's weights.
// The loop's step number is the lockstep one; a query's own count equals it
// because a query that is done never moves again, so the kernel's leaves
// equal the loop's.  Each thread's iteration count (max_steps + 1 if it
// never stops) is reduced into n_max, from which the caller forms the
// loop's lockstep step count.  Every multiply, add and subtract is an
// __f*_rn intrinsic (and the build keeps -fmad=false), so the weights agree
// with the loop's to the bit.  The results go to row idx[i] of the batch's
// leaf, w and in_domain in place; or, in value mode (vals given,
// device_tri.interp's route), the query's value alone goes to vals[idx[i]]
// (bary2d.cuh, the same epilogue as cells2d.cu's).
//
// Bound.  Per walked query: idx 8 B, q 8 B, hint 4 B, then per step its
// simplex's 32 B affine row and the one 4 B neighbour entry it reads, for
// a walk cut at max_steps the 32 B row of the simplex it ends on, and 21 B
// out (leaf 8, weights 12, in_domain 1); in value mode 4 B out and the
// 16 B response row of the simplex it ends on in.  At the 1M cell's shape
// (about 9,100-9,700 walked queries a batch of 2*10^7, 4.5-4.6 iterations on
// average, 11-12 at most, none cut) that is 1.9-2.0 MB, 0.55-0.60 us at
// 3.35 TB/s (chip_smoke.walk2d_bound_ms): the kernel is bound by latency,
// a chain of 3 + 2 * steps dependent loads, each a trip to L2 or HBM of
// about half a microsecond to a microsecond.  So one thread walks one query (a lane group would share
// loads that are not the limit), and the blocks are small, so the few
// thousand threads spread over every SM.  On an H100 SXM at 700 W, at that
// shape, it took 0.0108-0.0110 ms a batch at 64 threads a block, 0.0108-
// 0.0111 at 32, 0.0111-0.0116 at 128 and 0.0116-0.0118 at 256, against
// 5.1 ms for the loop (PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>

#include "bary2d.cuh"

namespace {

constexpr int kThreads = 64;

// torch.argmin's order (LessOrNan): whether (a, ia) comes before (b, ib).
__device__ __forceinline__ bool less_or_nan(float a, int ia, float b, int ib) {
  if (a != a) return b != b ? ia < ib : true;
  if (b != b) return false;
  return a == b ? ia < ib : a < b;
}

__device__ __forceinline__ int argmin3(const float w[3]) {
  int best = 0;
  if (less_or_nan(w[1], 1, w[best], best)) best = 1;
  if (less_or_nan(w[2], 2, w[best], best)) best = 2;
  return best;
}

__device__ __forceinline__ int cell_of(float s, float G, float top) {
  return static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(s, 0.5f), G)), 0.0f), top));
}

// The weights of simplex t at raw query (qx, qy): device_tri._weights.
__device__ __forceinline__ void weights(const float4* __restrict__ affine, int t, float qx,
                                        float qy, float w[3]) {
  const float4 a0 = __ldg(affine + 2 * static_cast<size_t>(t));
  const float4 a1 = __ldg(affine + 2 * static_cast<size_t>(t) + 1);
  const float e0 = __fsub_rn(qx, a1.x);
  const float e1 = __fsub_rn(qy, a1.y);
  w[0] = __fadd_rn(__fadd_rn(__fmul_rn(a0.x, e0), __fmul_rn(a0.y, e1)), a1.z);
  w[1] = __fadd_rn(__fadd_rn(__fmul_rn(a0.z, e0), __fmul_rn(a0.w, e1)), a1.w);
  w[2] = __fsub_rn(1.0f, __fadd_rn(w[0], w[1]));
}

// kValues: the value mode (vals, not leaf, w and in_domain).
template <bool kValues>
__global__ void __launch_bounds__(kThreads)
walk2d_kernel(const float2* __restrict__ q, const long long* __restrict__ idx, int n_walk,
              const float* __restrict__ shift, const float* __restrict__ scale,
              const int* __restrict__ hint, int G, const int* __restrict__ nbrs,
              const float4* __restrict__ affine, int max_steps, float tol,
              const float4* __restrict__ resp_rows, long long* __restrict__ leaf, float* __restrict__ w_out,
              bool* __restrict__ in_domain, float* __restrict__ vals,
              int* __restrict__ n_max) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int n = 0;  // this query's iterations; 0 for a thread with no query
  if (i < n_walk) {
    const long long row = idx[i];
    const float2 qi = q[row];
    const float Gf = static_cast<float>(G);
    const float top = static_cast<float>(G - 1);
    const int cx = cell_of(__fmul_rn(scale[0], __fsub_rn(qi.x, shift[0])), Gf, top);
    const int cy = cell_of(__fmul_rn(scale[1], __fsub_rn(qi.y, shift[1])), Gf, top);
    int cur = __ldg(hint + cx * G + cy);
    int prev = -1;
    bool outside = false;
    float w[3];
    n = max_steps + 1;
    for (int s = 0; s < max_steps; ++s) {
      weights(affine, cur, qi.x, qi.y, w);
      int worst = argmin3(w);
      if (s & 1) {
        const int neg = (w[0] < -tol) + (w[1] < -tol) + (w[2] < -tol);
        if (neg > 1) {
          const float w2[3] = {worst == 0 ? INFINITY : w[0], worst == 1 ? INFINITY : w[1],
                               worst == 2 ? INFINITY : w[2]};
          worst = argmin3(w2);
        }
      }
      const bool inside = w[0] >= -tol && w[1] >= -tol && w[2] >= -tol;
      const int nbr = __ldg(nbrs + 3 * static_cast<size_t>(cur) + worst);
      const bool hit_boundary = nbr < 0 && !inside;
      if (inside || hit_boundary || nbr == prev) {
        outside = hit_boundary;
        n = s + 1;
        break;
      }
      prev = cur;
      cur = nbr;
    }
    const float4 r = kValues ? __ldg(resp_rows + cur) : float4{};
    weights(affine, cur, qi.x, qi.y, w);
    const bool contained = w[0] >= -tol && w[1] >= -tol && w[2] >= -tol;
    const bool sane = w[0] > -0.5f && w[1] > -0.5f && w[2] > -0.5f;
    const bool ok = !outside && (contained || n <= max_steps) && sane;
    if (kValues) {
      vals[row] = bary_value(r, w[0], w[1], w[2], ok);
    } else {
      leaf[row] = cur;
      float* wr = w_out + 3 * row;
      wr[0] = w[0];
      wr[1] = w[1];
      wr[2] = w[2];
      in_domain[row] = ok;
    }
  }
  n = __reduce_max_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && n > 0) atomicMax(n_max, n);
}

}  // namespace

// q: [B, 2] float32, raw, 8-byte aligned; idx: [n_walk] int64, the rows to
// walk; shift, scale: [2] float32; hint: [G * G] int32; nbrs: [T, 3] int32
// (-1 a boundary face); affine: [T, 8] float32, 16-byte aligned.  Either
// leaf: [B] int64, w: [B, 3] float32 and in_domain: [B] bool, written at
// the rows of idx, with resp_rows and vals null; or (the value mode)
// resp_rows: [T, 4] float32, 16-byte aligned, and vals: [B] float32,
// written at the rows of idx, with leaf, w and in_domain null.  n_max:
// one int32, set to the largest iteration count (0 if n_walk is 0).  All
// contiguous on the current device; tol is the walk's (positive) slack.
// Queues a memset of n_max and one kernel on `stream` and returns the
// first CUDA error.
extern "C" int walk2d_launch(const void* q, const void* idx, int n_walk, const void* shift,
                             const void* scale, const void* hint, int G, const void* nbrs,
                             const void* affine, int max_steps, float tol,
                             const void* resp_rows, void* leaf, void* w, void* in_domain,
                             void* vals, void* n_max, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_max, 0, sizeof(int), s);
  if (err != cudaSuccess || n_walk == 0) return static_cast<int>(err);
  const int blocks = (n_walk + kThreads - 1) / kThreads;
  const auto kernel = vals != nullptr ? walk2d_kernel<true> : walk2d_kernel<false>;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float2*>(q), static_cast<const long long*>(idx), n_walk,
      static_cast<const float*>(shift), static_cast<const float*>(scale),
      static_cast<const int*>(hint), G, static_cast<const int*>(nbrs),
      static_cast<const float4*>(affine), max_steps, tol, static_cast<const float4*>(resp_rows),
      static_cast<long long*>(leaf), static_cast<float*>(w),
      static_cast<bool*>(in_domain), static_cast<float*>(vals), static_cast<int*>(n_max));
  return static_cast<int>(cudaGetLastError());
}
