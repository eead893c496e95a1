// Flip-candidate verdicts of the 2D Delaunay build on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// gsl_scattered_interpolation_tpu/ops/pallas_candmath.py::_kernel (:43-96),
// which computes the same verdict as _edge_candidates_math in
// gsl_scattered_interpolation_tpu/models/device_delaunay.py (:364-410).
// For edge e of row r, with apex a = apex3[r][e], shared-edge ends
// p1 = apex3[r][(e+1)%3], p2 = apex3[r][(e+2)%3] and far vertex
// f = fq3[r][e] across the edge:
//   convex = sign(orient2d_ds(a, f, p1)) * sign(orient2d_ds(a, f, p2)) < 0
//   sort (a, p1, f, p2) by vertex id with a 5-comparator network
//   S = incircle_ds(sorted) * sign(orient2d_ds(sorted[0..2]))
//   want = (S > 0 ? largest id at position 0 or 2 : at 1 or 3) && S != 0
//   ok = valid && convex && (want || !cok[r] || degen_u)
// orient2d_ds and incircle_ds are the compensated (double-single)
// predicates of ops/robust.py, written out in the same operation order.
//
// Bound.  Per edge, with each distinct value computed once and only what
// the verdict uses: 736 float operations (three compensated orients of 87,
// one compensated incircle of 464, 11 for the signs and the verdict) and
// 58 integer and select operations (the sort, the largest-id rule, the
// boolean verdict); see FLOAT_OPS_PER_EDGE and OTHER_OPS_PER_EDGE in
// ops/candmath.py.  Against about 82 bytes per row in float32 (apex and
// far coordinates 48, ids 24, masks 7, verdicts 3) it is bound by
// operations.  In float32 every operation takes an issue slot, 33.5e12 per
// s on an H100 SXM: at 400,003 rows, 3 * 400,003 * 794 / 33.5e12 s is
// about 28 us, the bytes about 10 us.  In float64 the FP64 pipe, at 17e12
// per s, bounds it: about 52 us.
//
// Design.  One thread per (row, edge), everything in registers, no shared
// memory: the work is a long elementwise chain and the loads are a few
// bytes per thread.  Built with -fmad=false: each multiply and add rounds
// on its own, so the error-free transforms stay exact and the verdicts
// equal those of the eager PyTorch plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Split;
template <>
struct Split<float> {
  static constexpr float value = 4097.0f;  // 2^12 + 1
};
template <>
struct Split<double> {
  static constexpr double value = 134217729.0;  // 2^27 + 1
};

template <typename T>
struct Pair {
  T h, l;
};

template <typename T>
__device__ __forceinline__ Pair<T> two_sum(T a, T b) {
  const T s = a + b;
  const T bb = s - a;
  const T err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

template <typename T>
__device__ __forceinline__ Pair<T> two_prod(T a, T b) {
  const T sc = Split<T>::value;
  const T p = a * b;
  const T a1 = a * sc;
  const T ahi = a1 - (a1 - a);
  const T alo = a - ahi;
  const T b1 = b * sc;
  const T bhi = b1 - (b1 - b);
  const T blo = b - bhi;
  const T err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
  return {p, err};
}

template <typename T>
__device__ __forceinline__ Pair<T> p_add(Pair<T> x, Pair<T> y) {
  Pair<T> s = two_sum(x.h, y.h);
  s.l = s.l + (x.l + y.l);
  return two_sum(s.h, s.l);
}

template <typename T>
__device__ __forceinline__ Pair<T> p_sub(Pair<T> x, Pair<T> y) {
  return p_add(x, Pair<T>{-y.h, -y.l});
}

template <typename T>
__device__ __forceinline__ Pair<T> p_mul(Pair<T> x, Pair<T> y) {
  Pair<T> p = two_prod(x.h, y.h);
  p.l = p.l + (x.h * y.l + x.l * y.h);
  return two_sum(p.h, p.l);
}

template <typename T>
__device__ __forceinline__ Pair<T> p_diff(T a, T b) {
  return two_sum(a, -b);
}

template <typename T>
__device__ __forceinline__ T orient2d_ds(T ax, T ay, T bx, T by, T cx, T cy) {
  const Pair<T> acx = p_diff(ax, cx);
  const Pair<T> acy = p_diff(ay, cy);
  const Pair<T> bcx = p_diff(bx, cx);
  const Pair<T> bcy = p_diff(by, cy);
  return p_sub(p_mul(acx, bcy), p_mul(acy, bcx)).h;
}

template <typename T>
__device__ __forceinline__ T incircle_ds(const T* x, const T* y) {
  const Pair<T> adx = p_diff(x[0], x[3]);
  const Pair<T> ady = p_diff(y[0], y[3]);
  const Pair<T> bdx = p_diff(x[1], x[3]);
  const Pair<T> bdy = p_diff(y[1], y[3]);
  const Pair<T> cdx = p_diff(x[2], x[3]);
  const Pair<T> cdy = p_diff(y[2], y[3]);
  const Pair<T> ad2 = p_add(p_mul(adx, adx), p_mul(ady, ady));
  const Pair<T> bd2 = p_add(p_mul(bdx, bdx), p_mul(bdy, bdy));
  const Pair<T> cd2 = p_add(p_mul(cdx, cdx), p_mul(cdy, cdy));
  const Pair<T> m1 = p_sub(p_mul(bdy, cd2), p_mul(cdy, bd2));
  const Pair<T> m2 = p_sub(p_mul(bdx, cd2), p_mul(cdx, bd2));
  const Pair<T> m3 = p_sub(p_mul(bdx, cdy), p_mul(cdx, bdy));
  const Pair<T> t1 = p_mul(adx, m1);
  const Pair<T> t2 = p_mul(ady, m2);
  const Pair<T> t3 = p_mul(ad2, m3);
  return p_add(p_sub(t1, t2), t3).h;
}

// sign() as torch.sign and jnp.sign: -1, 0 or 1, and NaN stays NaN.
template <typename T>
__device__ __forceinline__ T sign(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : (v == T(0) ? T(0) : v));
}

template <typename T>
__device__ __forceinline__ void compare_swap(int i, int j, int* id, T* x,
                                             T* y) {
  if (id[i] > id[j]) {
    const int ti = id[i];
    id[i] = id[j];
    id[j] = ti;
    const T tx = x[i];
    x[i] = x[j];
    x[j] = tx;
    const T ty = y[i];
    y[i] = y[j];
    y[j] = ty;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
candmath2d_kernel(const T* __restrict__ apex3, const T* __restrict__ fq3,
                  const int* __restrict__ tv, const int* __restrict__ far3,
                  const uint8_t* __restrict__ valid3,
                  const uint8_t* __restrict__ cok,
                  const uint8_t* __restrict__ degen_u, int n_rows,
                  uint8_t* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;  // row * 3 + edge
  if (k >= 3 * n_rows) return;
  const int r = k / 3;
  const int e = k - 3 * r;
  const int e1 = e == 2 ? 0 : e + 1;
  const int e2 = e == 0 ? 2 : e - 1;
  const T* row = apex3 + 6 * r;
  const T ax = row[2 * e], ay = row[2 * e + 1];
  const T p1x = row[2 * e1], p1y = row[2 * e1 + 1];
  const T p2x = row[2 * e2], p2y = row[2 * e2 + 1];
  const T fx = fq3[2 * k], fy = fq3[2 * k + 1];
  const int a_id = tv[3 * r + e], p1_id = tv[3 * r + e1];
  const int p2_id = tv[3 * r + e2], f_id = far3[k];

  // 1. Convexity: the segment (apex, far) crosses the shared edge.
  const T o1 = orient2d_ds(ax, ay, fx, fy, p1x, p1y);
  const T o2 = orient2d_ds(ax, ay, fx, fy, p2x, p2y);
  const bool convex = sign(o1) * sign(o2) < T(0);

  // 2. Sort (apex, p1, far, p2) by id.
  int id[4] = {a_id, p1_id, f_id, p2_id};
  T x[4] = {ax, p1x, fx, p2x};
  T y[4] = {ay, p1y, fy, p2y};
  compare_swap(0, 1, id, x, y);
  compare_swap(2, 3, id, x, y);
  compare_swap(0, 2, id, x, y);
  compare_swap(1, 3, id, x, y);
  compare_swap(1, 2, id, x, y);

  // 3. The canonical incircle of the sorted quad.
  const T O = orient2d_ds(x[0], y[0], x[1], y[1], x[2], y[2]);
  const T S = incircle_ds(x, y) * sign(O);

  // 4. Position of the largest id in (apex, p1, far, p2), the first on a
  // tie as argmax takes it.
  const int m01 = max(a_id, p1_id);
  const int m23 = max(f_id, p2_id);
  const int p3 = m01 >= m23 ? (a_id >= p1_id ? 0 : 1)
                            : (f_id >= p2_id ? 2 : 3);
  const bool on_flip_diag = p3 == 0 || p3 == 2;
  const bool want = (S > T(0) ? on_flip_diag : !on_flip_diag) && S != T(0);

  // 5. The verdict.
  out[k] = valid3[k] && convex && (want || !cok[r] || degen_u[k]);
}

}  // namespace

// apex3, fq3: [n_rows, 3, 2] float32 (is_double 0) or float64 (1);
// tv, far3: [n_rows, 3] int32; valid3, degen_u: [n_rows, 3] bool;
// cok: [n_rows] bool; out: [n_rows, 3] uint8; all contiguous on the current
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int candmath2d_launch(const void* apex3, const void* fq3,
                                 const void* tv, const void* far3,
                                 const void* valid3, const void* cok,
                                 const void* degen_u, int n_rows,
                                 int is_double, void* out, void* stream) {
  const int n = 3 * n_rows;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* i_tv = static_cast<const int*>(tv);
  const auto* i_far = static_cast<const int*>(far3);
  const auto* b_valid = static_cast<const uint8_t*>(valid3);
  const auto* b_cok = static_cast<const uint8_t*>(cok);
  const auto* b_degu = static_cast<const uint8_t*>(degen_u);
  auto* o = static_cast<uint8_t*>(out);
  if (is_double) {
    candmath2d_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(apex3), static_cast<const double*>(fq3),
        i_tv, i_far, b_valid, b_cok, b_degu, n_rows, o);
  } else {
    candmath2d_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(apex3), static_cast<const float*>(fq3),
        i_tv, i_far, b_valid, b_cok, b_degu, n_rows, o);
  }
  return static_cast<int>(cudaGetLastError());
}
