// 2D point location by the cell index on Hopper (sm_90a): the candidate
// scoring of models/device_tri.py::locate_cells, through the walk mask,
// and for device_tri.interp each query's value besides.
//
// Replaces no Pallas kernel: the JAX package scores a query's cell with
// XLA ops (gsl_scattered_interpolation_tpu/models/device_tri.py::
// locate_cells, the 2D branch), and the port's plain version is the same
// torch code (models/device_tri.py::_locate_cells_score_2d).  That code
// gathers every query's whole row into a [B, 7K] intermediate and then
// makes a dozen [B, K] passes over it; this kernel reads each row once and
// writes only the results.
//
// For query q (raw) and the row of its cell (7 fields of K slots, field-
// major: g00, g01, g10, g11, b0, b1, tid):
//   d = q - shift,  q_std = scale * d
//   cell = clamp(floor((q_std + 0.5) * G), 0, G - 1),  cid = cx * G + cy
//   c0 = (g00 * dx + g01 * dy) + b0,  c1 = (g10 * dx + g11 * dy) + b1
//   minw = min(min(c0, c1), (1 - c0) - c1), -inf where tid < 0
// The best slot is torch.argmax's: NaN above every number, the lowest slot
// on a tie.  leaf = max(tid[best], 0); its weights come from the [T, 8]
// affine row (A00 A01 A10 A11 ax ay w00 w01) in device_tri._weights' order;
// contained = minw[best] >= tol, w_ok = every weight >= tol (tol is float32's
// slack for both, as the score table and the queries are float32),
// outside = any |q_std| > 0.5, and the walk mask
//   complete:   ((overflow[cid] | outside) & ~contained) | (contained & ~w_ok)
//   otherwise:  ~(contained & w_ok).
// Every multiply, add and subtract is an __f*_rn intrinsic (and the build
// keeps -fmad=false), so each rounds on its own as the eager torch ops do,
// and kernel and plain version agree to the bit.  torch.minimum passes NaN
// on, so the mins do too.  A NaN query, which the plain version cannot
// index, lands in cell 0 and comes out not contained.
//
// Value mode (vals given, interp's route): lane 0 also reads the leaf's
// 16-byte row of vertex responses (device_tri.vertex_responses) beside its
// affine row, and writes the value (bary2d.cuh, the tail of
// device_tri.interp) and the walk mask instead of leaf, weights and
// in_domain.  One load beside the affine row, not the vertex ids and then
// the responses: that chain of two dependent loads took 4.33 ms a batch at
// the 1M cell's shape, 0.56 ms more than the scoring alone (PERF.md §6).
//
// Bound.  Per query: 8 B of query, the 7K * 4 = 448 B row (K = 16) from a
// table far larger than the 50 MB L2, the 32 B affine row, 1 B of overflow,
// and 22 B out (leaf 8, weights 12, in_domain 1, bad 1): about 511 B, so at
// 3.35 TB/s 0.153 ms per 10^6 queries.  In value mode the out is 5 B (value
// 4, bad 1) and the 16 B response row comes in: about 510 B, 0.152 ms per
// 10^6.  The work is a few dozen float instructions per slot: memory-bound
// by two orders of magnitude.
//
// Design.  kLanes = 8 lanes score one query, each two adjacent slots a
// pass (slots 2l, 2l + 1, then 2l + 16, ... when K > 16): each field's
// loads then cover 64 contiguous bytes across the 8 lanes, one 8-byte load
// a lane where K is even (two 4-byte loads cost 8 % more at K = 16), and
// with K = 16 a row is exactly 14 sectors of 32 B.  No shared memory: the
// rows are read once, so staging them buys nothing; what hides the HBM
// latency is the number of rows in flight, four queries a warp.  The
// arg-max meets across the 8 lanes with __shfl_xor_sync under the argmax
// order, which is a total order, so the tree gives the sequential scan's
// slot.  Lane 0 of each group does the epilogue: the affine row, the
// weights, the masks.  At the 1M cell's shape (2*10^7 queries, K = 16, on
// an H100 SXM at 700 W) it ran at 81 % of the bound; 16 lanes of one slot,
// 4 lanes of four, two queries a group and one thread a query (47 %) were
// slower (PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>

#include "bary2d.cuh"

namespace {

constexpr int kLanes = 8;     // lanes per query
constexpr int kSlots = 2;     // adjacent slots a lane scores per pass
constexpr int kPass = kLanes * kSlots;
constexpr int kThreads = 256;
constexpr int kQueriesPerBlock = kThreads / kLanes;
constexpr int kFields = 7;    // g00 g01 g10 g11 b0 b1 tid

// torch.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// Whether (a, slot ia) comes before (b, slot ib) in torch.argmax's order:
// NaN above every number (the lower slot of two NaNs), else the larger
// value, the lower slot on a tie (-0 ties +0).
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a;
  const bool nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ int cell_of(float s, float G, float top) {
  return static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(s, 0.5f), G)), 0.0f), top));
}

// kEven: K is even, so a lane's two slots are one aligned 8-byte load.
// kValues: the value mode (vals, not leaf, w and in_domain).
template <bool kEven, bool kValues>
__global__ void __launch_bounds__(kThreads)
cells2d_kernel(const float2* __restrict__ q, const float* __restrict__ shift,
               const float* __restrict__ scale, const float* __restrict__ table,
               const unsigned char* __restrict__ overflow,
               const float4* __restrict__ affine, int n_q, int G, int K, int complete,
               float tol, const float4* __restrict__ resp_rows, long long* __restrict__ leaf,
               float* __restrict__ w, bool* __restrict__ in_domain, float* __restrict__ vals,
               bool* __restrict__ bad) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int i = blockIdx.x * kQueriesPerBlock + threadIdx.x / kLanes;
  if (i >= n_q) return;  // the query's lanes leave together
  const unsigned group = 0xFFu << (threadIdx.x & (32 - kLanes));

  const float2 qi = q[i];
  const float dx = __fsub_rn(qi.x, shift[0]);
  const float dy = __fsub_rn(qi.y, shift[1]);
  const float sx = __fmul_rn(scale[0], dx);
  const float sy = __fmul_rn(scale[1], dy);
  const float Gf = static_cast<float>(G);
  const float top = static_cast<float>(G - 1);
  const int cid = cell_of(sx, Gf, top) * G + cell_of(sy, Gf, top);
  const unsigned char ovf = lane == 0 ? __ldg(overflow + cid) : 0;
  const float* row = table + static_cast<size_t>(cid) * kFields * K;

  // A lane with no slot left holds one that every real slot beats.
  float best = -INFINITY;
  int best_slot = 0x7FFFFFFF;
  float best_tid = -1.0f;
  for (int s = kSlots * lane; s < K; s += kPass) {
    float v[kFields][kSlots];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      if (kEven) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(row + f * K + s));
        v[f][0] = x.x;
        v[f][1] = x.y;
      } else {
        v[f][0] = __ldg(row + f * K + s);
        v[f][1] = s + 1 < K ? __ldg(row + f * K + s + 1) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (s + j == K) break;
      const float c0 = __fadd_rn(__fadd_rn(__fmul_rn(v[0][j], dx), __fmul_rn(v[1][j], dy)),
                                 v[4][j]);
      const float c1 = __fadd_rn(__fadd_rn(__fmul_rn(v[2][j], dx), __fmul_rn(v[3][j], dy)),
                                 v[5][j]);
      float mw = min_nan(min_nan(c0, c1), __fsub_rn(__fsub_rn(1.0f, c0), c1));
      if (!(v[6][j] >= 0.0f)) mw = -INFINITY;
      if (beats(mw, s + j, best, best_slot)) {
        best = mw;
        best_slot = s + j;
        best_tid = v[6][j];
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(group, best, off);
    const int os = __shfl_xor_sync(group, best_slot, off);
    const float ot = __shfl_xor_sync(group, best_tid, off);
    if (beats(ob, os, best, best_slot)) {
      best = ob;
      best_slot = os;
      best_tid = ot;
    }
  }
  if (lane != 0) return;

  const int t = static_cast<int>(fmaxf(best_tid, 0.0f));
  const float4 r = kValues ? __ldg(resp_rows + t) : float4{};
  const float4 a0 = __ldg(affine + 2 * static_cast<size_t>(t));
  const float4 a1 = __ldg(affine + 2 * static_cast<size_t>(t) + 1);
  const float e0 = __fsub_rn(qi.x, a1.x);
  const float e1 = __fsub_rn(qi.y, a1.y);
  const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(a0.x, e0), __fmul_rn(a0.y, e1)), a1.z);
  const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(a0.z, e0), __fmul_rn(a0.w, e1)), a1.w);
  const float w2 = __fsub_rn(1.0f, __fadd_rn(w0, w1));
  const bool contained = best >= tol;
  const bool w_ok = w0 >= tol && w1 >= tol && w2 >= tol;
  const bool outside = fabsf(sx) > 0.5f || fabsf(sy) > 0.5f;
  if (kValues) {
    vals[i] = bary_value(r, w0, w1, w2, contained && w_ok);
  } else {
    leaf[i] = t;
    float* wi = w + 3 * static_cast<size_t>(i);
    wi[0] = w0;
    wi[1] = w1;
    wi[2] = w2;
    in_domain[i] = contained && w_ok;
  }
  bad[i] = complete ? (((ovf != 0) || outside) && !contained) || (contained && !w_ok)
                    : !(contained && w_ok);
}

}  // namespace

// q: [n_q, 2] float32, raw; shift, scale: [2] float32; table: [G * G, 7K]
// float32; overflow: [G * G] bool; affine: [T, 8] float32, 16-byte
// aligned; bad: [n_q] bool.  Either leaf: [n_q] int64, w: [n_q, 3]
// float32 and in_domain: [n_q] bool, with resp_rows and vals null; or (the
// value mode) resp_rows: [T, 4] float32, 16-byte aligned, and vals: [n_q]
// float32, with leaf, w and in_domain null.  All contiguous on the current device.  tol is the (negative)
// float32 slack of the score and of the weights.  Launches one kernel on
// `stream` and returns cudaGetLastError().
extern "C" int cells2d_launch(const void* q, const void* shift, const void* scale,
                              const void* table, const void* overflow, const void* affine,
                              int n_q, int G, int K, int complete, float tol,
                              const void* resp_rows, void* leaf, void* w, void* in_domain,
                              void* vals, void* bad, void* stream) {
  const int blocks = (n_q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const bool even = K % 2 == 0;
  const auto kernel = vals != nullptr ? (even ? cells2d_kernel<true, true>
                                              : cells2d_kernel<false, true>)
                                      : (even ? cells2d_kernel<true, false>
                                              : cells2d_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(q), static_cast<const float*>(shift),
      static_cast<const float*>(scale), static_cast<const float*>(table),
      static_cast<const unsigned char*>(overflow), static_cast<const float4*>(affine), n_q,
      G, K, complete, tol, static_cast<const float4*>(resp_rows), static_cast<long long*>(leaf), static_cast<float*>(w), static_cast<bool*>(in_domain),
      static_cast<float*>(vals), static_cast<bool*>(bad));
  return static_cast<int>(cudaGetLastError());
}
