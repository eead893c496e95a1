// Symmetric tridiagonal solve (Thomas algorithm) on Hopper (sm_90a), for m
// right-hand sides that share one matrix.
//
// There is no Pallas kernel behind it: the JAX package solves the cubic
// spline systems with two lax.scan sweeps,
// gsl_scattered_interpolation_tpu/ops/tridiag.py:16-50, compiled into one
// loop on the TPU.  In eager PyTorch that recurrence would be a dozen
// launches per row, so this kernel takes it.  For rows i = 0..n-1, with
// e_i = offdiag[i] (0 past the last row) and e_{-1} = 0:
//   denom = d_i - e_{i-1} * c'_{i-1}
//   c'_i  = e_i / denom
//   d'_i  = (b_i - e_{i-1} * d'_{i-1}) / denom
// then x_{n-1} = d'_{n-1} - c'_{n-1} * 0 and x_i = d'_i - c'_i * x_{i+1}:
// JAX's operations in JAX's order.  Built with -fmad=false, every product
// and sum rounds on its own, and '/' is IEEE division (nvcc's default
// -prec-div=true), so x equals the eager PyTorch plain version bit for bit.
//
// Layout.  rhs and x are [n, m] row-major: thread j solves column j, and
// the 32 threads of a warp read 32 neighbouring values of a row.  d'
// goes into x and c' into the scratch cp [n, m] during the forward sweep;
// the back substitution reads both and overwrites x.  The forward sweep
// loads its rows 8 at a time into registers, the next 8 in flight while
// the current 8 dependent steps run; the back substitution loads 32 rows
// at a time.  So memory latency hides behind the recurrence.
//
// Bound.  Bytes: diag and offdiag once (16 n in float64), rhs and x once
// each (16 n m); 8 operations per row and column (division counted as
// one).  So it is bound by bytes: at n = 2,046, m = 2,048 in float64 about
// 67 MB, 20 us at 3.35 TB/s.  At m = 1 (one spline) the kernel is one
// thread walking 10^6 dependent steps, each a multiply, a subtract and a
// division (tens of cycles of latency), so it takes tens of milliseconds
// against a 10 us bound: latency-bound by the recurrence, not by memory
// or arithmetic.  A partitioned or cyclic-reduction solve would spread
// one system over many threads; this kernel is the simple, exact one.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kFwd = 8;    // rows per forward chunk, the next one in flight
constexpr int kBwd = 32;   // rows per back-substitution chunk

template <typename T>
__device__ __forceinline__ void load_fwd(const T* __restrict__ diag,
                                         const T* __restrict__ offdiag,
                                         const T* __restrict__ rhs, int i0,
                                         int n, size_t mm, int j, T* dk, T* ek,
                                         T* bk) {
#pragma unroll
  for (int k = 0; k < kFwd; ++k) {
    const int i = i0 + k;
    dk[k] = i < n ? diag[i] : T(0);
    ek[k] = i < n - 1 ? offdiag[i] : T(0);
    bk[k] = i < n ? rhs[i * mm + j] : T(0);
  }
}

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ diag,
                              const T* __restrict__ offdiag,
                              const T* __restrict__ rhs, T* __restrict__ cp,
                              T* __restrict__ x, int n, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const size_t mm = static_cast<size_t>(m);
  T c_prev = T(0), d_prev = T(0), e_prev = T(0);
  T dk[kFwd], ek[kFwd], bk[kFwd];
  load_fwd(diag, offdiag, rhs, 0, n, mm, j, dk, ek, bk);
  for (int i0 = 0; i0 < n; i0 += kFwd) {
    // The next chunk's loads go out before this chunk's dependent steps.
    T dn[kFwd], en[kFwd], bn[kFwd];
    load_fwd(diag, offdiag, rhs, i0 + kFwd, n, mm, j, dn, en, bn);
#pragma unroll
    for (int k = 0; k < kFwd; ++k) {
      const int i = i0 + k;
      if (i < n) {
        const T denom = dk[k] - e_prev * c_prev;
        c_prev = ek[k] / denom;
        d_prev = (bk[k] - e_prev * d_prev) / denom;
        cp[i * mm + j] = c_prev;
        x[i * mm + j] = d_prev;
        e_prev = ek[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kFwd; ++k) {
      dk[k] = dn[k];
      ek[k] = en[k];
      bk[k] = bn[k];
    }
  }
  T x_next = T(0);
  for (int i1 = n - 1; i1 >= 0; i1 -= kBwd) {
    T ck[kBwd], pk[kBwd];
#pragma unroll
    for (int k = 0; k < kBwd; ++k) {
      const int i = i1 - k;
      ck[k] = i >= 0 ? cp[i * mm + j] : T(0);
      pk[k] = i >= 0 ? x[i * mm + j] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kBwd; ++k) {
      const int i = i1 - k;
      if (i >= 0) {
        x_next = pk[k] - ck[k] * x_next;
        x[i * mm + j] = x_next;
      }
    }
  }
}

}  // namespace

// diag [n], offdiag [n-1], rhs [n, m], scratch cp [n, m] and out x [n, m],
// all float32 (is_double 0) or float64 (1), contiguous.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int tridiag_launch(const void* diag, const void* offdiag,
                              const void* rhs, void* cp, void* x, int n, int m,
                              int is_double, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    thomas_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(diag), static_cast<const double*>(offdiag),
        static_cast<const double*>(rhs), static_cast<double*>(cp),
        static_cast<double*>(x), n, m);
  } else {
    thomas_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(diag), static_cast<const float*>(offdiag),
        static_cast<const float*>(rhs), static_cast<float*>(cp),
        static_cast<float*>(x), n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
