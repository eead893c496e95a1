// 2D brute-force point location on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// gsl_scattered_interpolation_tpu/ops/pallas_locate.py::_kernel (:35-75).
// For query q (centred at the triangulation's shift) and triangle t:
//   c0 = (q.x * g0x[t] + q.y * g0y[t]) + b0[t]
//   c1 = (q.x * g1x[t] + q.y * g1y[t]) + b1[t]
//   score = min(min(c0, c1), (1 - c0) - c1)
// and the result is the index of the largest score, the lowest index on a
// tie; 0 when no score lies above -inf.  The kernel takes raw queries and
// subtracts the centre itself.  Degenerate triangles carry a bias
// of -1e30 and never win.  Optionally it also emits the leaf's barycentric
// weights from the affine maps, as models/device_tri.py::_weights does.
//
// Bound.  Per (query, triangle) the work is 13 float32 instructions
// (4 mul, 4 add, 2 sub, 2 min, 1 compare) against 8 bytes read and 4
// written per query, so at T = 4,001 triangles it is instruction-bound:
// 13 * T * B / (132 SMs * 128 lanes * ~1.98 GHz), about 1.55 ms per
// million queries on an H100 SXM.  Built with -fmad=false, no multiply-add
// contracts, so 13 issued instructions per pair is the floor.  Measured on
// an H100 SXM at 700 W (tools/locate_tune.py, tools/locate_probe.py): the
// hot loop issues about 13.3 instructions per pair (cuobjdump), but a pair
// takes 15.8-16.6 scheduler cycles at the 1,980 MHz the card holds under
// this load, 76-82 % of the bound.  With its min and max turned into adds
// the loop still takes 15.5: the mix issues at about 86 % of one a cycle,
// and the running max costs the rest.
//
// Design.
// * Register blocking: each thread holds kRows queries, so one read of a
//   triangle from shared memory feeds kRows pairs.
// * Group max: the sweep keeps a running fmaxf over kGroup triangles (one
//   instruction per pair, the bound's compare) and, once per group,
//   records the group if its max beats the best so far by a strict '>'.
//   After the sweep the winning group is scored again, from device memory,
//   with the same instructions, and the first index whose score equals the
//   best is the leaf: the sequential strict-'>' scan's answer, since '=='
//   and '>' both treat -0 as +0, fmaxf drops NaN as '>' never picks it,
//   and a later group must beat an earlier one strictly.
// * Split over triangles: the grid is (query tile, triangle slice), chosen
//   by the wrapper (ops/locate.py::plan) so the blocks cover every SM
//   evenly.  Slices of one tile merge through a 64-bit atomicMax on a key
//   whose high word orders the score (-0 folded to +0) and whose low word
//   is 0xFFFFFFFF - index: the largest key is the first index of the
//   largest score, whatever order the atomics land in.  A second kernel
//   turns the keys into leaves (and weights).  One slice needs neither.
// * Staging: the slice streams through shared memory in chunks of kChunk
//   triangles, double-buffered with cp.async, so the next chunk loads
//   while this one is scored.
// Every multiply, add and subtract is an __f*_rn intrinsic (and the build
// keeps -fmad=false), so each rounds on its own, as in the eager PyTorch
// plain version, and the two agree leaf for leaf and weight for weight.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;     // queries per thread
constexpr int kGroup = 32;   // triangles under one running max
constexpr int kChunk = 512;  // triangles per staged chunk, a multiple of kGroup
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float pair_score(float qx, float qy, float g0x,
                                            float g0y, float g1x, float g1y,
                                            float b0, float b1) {
  const float c0 = __fadd_rn(__fadd_rn(__fmul_rn(qx, g0x), __fmul_rn(qy, g0y)), b0);
  const float c1 = __fadd_rn(__fadd_rn(__fmul_rn(qx, g1x), __fmul_rn(qy, g1y)), b1);
  return fminf(fminf(c0, c1), __fsub_rn(__fsub_rn(1.0f, c0), c1));
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The merge key of (score, index); ops/locate.py::merge_key_ref mirrors it.
__device__ __forceinline__ long long merge_key(float s, int idx) {
  if (s == 0.0f) s = 0.0f;  // -0 orders as +0
  int o = __float_as_int(s);
  o ^= (o >> 31) & 0x7FFFFFFF;  // signed order of the bits = float order
  const unsigned long long hi = static_cast<unsigned long long>(static_cast<unsigned>(o)) << 32;
  return static_cast<long long>(hi | (0xFFFFFFFFu - static_cast<unsigned>(idx)));
}

// w_k = (A_k0 (qx - ax) + A_k1 (qy - ay)) + w0_k for k = 0, 1, and
// w_2 = 1 - (w_0 + w_1), from the [T, 8] row (A00 A01 A10 A11 ax ay w00 w01)
// of leaf t and the raw query.
__device__ __forceinline__ void emit_weights(float2 qr, const float* __restrict__ affine,
                                             int t, float* __restrict__ out) {
  const float* a = affine + 8 * static_cast<size_t>(t);
  const float d0 = __fsub_rn(qr.x, a[4]);
  const float d1 = __fsub_rn(qr.y, a[5]);
  const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(a[0], d0), __fmul_rn(a[1], d1)), a[6]);
  const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(a[2], d0), __fmul_rn(a[3], d1)), a[7]);
  out[0] = w0;
  out[1] = w1;
  out[2] = __fsub_rn(1.0f, __fadd_rn(w0, w1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (tile, slice): queries [tile * kRows * kThreads, +kRows * kThreads)
// against triangles [slice * slice_len, +slice_len).  Without keys (one
// slice) it writes leaf, and w if given; with keys it merges into them.
__global__ void __launch_bounds__(kThreads)
locate2d_kernel(const float2* __restrict__ q, const float* __restrict__ centre,
                const float* __restrict__ g, const float* __restrict__ b,
                const float* __restrict__ affine, int n_q, int n_t, int slice_len,
                long long* __restrict__ keys, int* __restrict__ leaf,
                float* __restrict__ w) {
  // Rows g0x g0y g1x g1y b0 b1 of two chunks.
  __shared__ __align__(16) float s_tab[2][6][kChunk];
  const int t0 = blockIdx.y * slice_len;
  const int t1 = min(n_t, t0 + slice_len);
  const int first = blockIdx.x * kRows * kThreads + threadIdx.x;
  const float cx = centre[0];
  const float cy = centre[1];

  float qx[kRows], qy[kRows], best[kRows];
  int best_grp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = first + r * kThreads;
    const float2 qi = i < n_q ? q[i] : make_float2(0.0f, 0.0f);
    qx[r] = __fsub_rn(qi.x, cx);
    qy[r] = __fsub_rn(qi.y, cy);
    best[r] = -INFINITY;
    best_grp[r] = t0;
  }

  auto stage = [&](int c, int buf) {
    const int base = t0 + c * kChunk;
    const int n = min(kChunk, t1 - base);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int t = base + k;
#pragma unroll
      for (int row = 0; row < 4; ++row) cp_async4(&s_tab[buf][row][k], g + row * n_t + t);
      cp_async4(&s_tab[buf][4][k], b + t);
      cp_async4(&s_tab[buf][5][k], b + n_t + t);
    }
    cp_async_commit();
  };

  const int n_chunks = (t1 - t0 + kChunk - 1) / kChunk;
  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int base = t0 + c * kChunk;
    const int n = min(kChunk, t1 - base);
    const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
    // Pad the last group with triangles that score -inf (or NaN): never a max.
    for (int k = n + threadIdx.x; k < n_pad; k += kThreads) {
#pragma unroll
      for (int row = 0; row < 4; ++row) s_tab[buf][row][k] = 0.0f;
      s_tab[buf][4][k] = -INFINITY;
      s_tab[buf][5][k] = -INFINITY;
    }
    __syncthreads();

    const float4* s4[6];
#pragma unroll
    for (int row = 0; row < 6; ++row) s4[row] = reinterpret_cast<const float4*>(s_tab[buf][row]);
    for (int grp = 0; grp < n_pad; grp += kGroup) {
      float gm[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) gm[r] = -INFINITY;
#pragma unroll 2
      for (int k = grp / 4; k < (grp + kGroup) / 4; ++k) {
        const float4 v0 = s4[0][k], v1 = s4[1][k], v2 = s4[2][k];
        const float4 v3 = s4[3][k], v4 = s4[4][k], v5 = s4[5][k];
        // Row by row, a row's four scores into its running max: faster
        // than triangle by triangle across the rows (tools/locate_probe.py).
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gm[r] = fmaxf(gm[r], pair_score(qx[r], qy[r], lane(v0, j), lane(v1, j),
                                            lane(v2, j), lane(v3, j), lane(v4, j),
                                            lane(v5, j)));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (gm[r] > best[r]) {
          best[r] = gm[r];
          best_grp[r] = base + grp;
        }
      }
    }
    __syncthreads();  // this buffer is restaged two chunks on
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = first + r * kThreads;
    if (i >= n_q) continue;
    // Rescan the winning group for the first index that reaches the best.
    int idx = 0;
    if (best[r] > -INFINITY) {
      const int end = min(best_grp[r] + kGroup, t1);
      for (int t = best_grp[r]; t < end; ++t) {
        const float s = pair_score(qx[r], qy[r], __ldg(g + t), __ldg(g + n_t + t),
                                   __ldg(g + 2 * n_t + t), __ldg(g + 3 * n_t + t),
                                   __ldg(b + t), __ldg(b + n_t + t));
        if (s == best[r]) {
          idx = t;
          break;
        }
      }
    }
    if (keys) {
      if (best[r] > -INFINITY) atomicMax(keys + i, merge_key(best[r], idx));
    } else {
      leaf[i] = idx;
      if (w) emit_weights(q[i], affine, idx, w + 3 * static_cast<size_t>(i));
    }
  }
}

// The split's merge pass: leaf (and weights) from each query's key.
__global__ void __launch_bounds__(kMergeThreads)
locate2d_merge(const float2* __restrict__ q, const float* __restrict__ affine,
               const long long* __restrict__ keys, int n_q, int* __restrict__ leaf,
               float* __restrict__ w) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n_q) return;
  const int t = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(keys[i] & 0xFFFFFFFFll));
  leaf[i] = t;
  if (w) emit_weights(q[i], affine, t, w + 3 * static_cast<size_t>(i));
}

}  // namespace

// q: [n_q, 2] float32, raw (the kernel subtracts centre: [2] float32);
// g: [4, n_t] float32 (rows g0x g0y g1x g1y); b: [2, n_t] float32 (rows
// b0 b1); affine: [n_t, 8] float32 or null; leaf: [n_q] int32; w:
// [n_q, 3] float32 or null (needs affine).  `slices` slices of
// `slice_len` triangles; for slices > 1, keys: [n_q] int64 filled with the
// key of (-inf, 0).  All contiguous on the current device.  Launches on
// `stream` (one kernel, two with slices > 1) and returns
// cudaGetLastError().  ops/locate.py reads kThreads, kGroup and kRows
// from this file.
extern "C" int locate2d_launch(const void* q, const void* centre, const void* g,
                               const void* b, const void* affine, int n_q, int n_t,
                               int slices, int slice_len, void* keys,
                               void* leaf, void* w, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qq = static_cast<const float2*>(q);
  const auto cc = static_cast<const float*>(centre);
  const auto gg = static_cast<const float*>(g);
  const auto bb = static_cast<const float*>(b);
  const auto aa = static_cast<const float*>(affine);
  auto kk = slices > 1 ? static_cast<long long*>(keys) : nullptr;
  const auto ll = static_cast<int*>(leaf);
  const auto ww = static_cast<float*>(w);
  const dim3 grid((n_q + kRows * kThreads - 1) / (kRows * kThreads), slices);
  locate2d_kernel<<<grid, kThreads, 0, s>>>(qq, cc, gg, bb, aa, n_q, n_t, slice_len, kk,
                                            ll, ww);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  locate2d_merge<<<(n_q + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      qq, aa, kk, n_q, ll, ww);
  return static_cast<int>(cudaGetLastError());
}
