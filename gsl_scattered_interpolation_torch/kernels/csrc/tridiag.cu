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
// or arithmetic (237 ms at n = 10^6 on an H100, about 235 ns per row: two
// chains of IEEE f64 divisions).  So this sequential route serves small
// systems and finishes the partitioned route's last reduced system.
//
// The partitioned route (tridiag_part_launch) spreads one system over
// many threads.  Every L-th row (L = kBlock = 32, ops/tridiag.py's BLOCK)
// is a separator; the L - 1 interior rows between two separators form an
// independent tridiagonal block that couples only to its two separators.
// The system is padded to nb * L rows, nb = ceil(n / L), with rows of
// diagonal 1, offdiag 0 and rhs 0.  Per level:
//   part_factor   one thread per block: r = 1 / denom (one IEEE
//                 reciprocal per row, so the columns' sweeps multiply and
//                 a zero numerator never reaches a division), c = e * r,
//                 and the spikes vL, vR (the block's response to its left
//                 and right separator), shared by every column;
//   part_sweep    one thread per (block, column): g = (b - ep * g') * r
//                 forward, y = g - c * y' back;
//   part_assemble one thread per (separator, column): the separators'
//                 Schur complement D, E (column 0) and B, a symmetric
//                 tridiagonal system of nb rows, strictly diagonally
//                 dominant when A is;
// then the reduced system is solved the same way, recursively, until it
// has at most L rows, where thomas_kernel finishes it; and on the way back
//   part_backfill one thread per (row, column): x = (y - XL vL) - XR vR.
// For one or two right-hand sides (m <= 2: one spline, or the cyclic
// solve's pair) part_factor_sweep does the factor and the sweeps
// in one thread per block, and part_backfill_tile (one thread per row)
// writes the rows through a tile: three kernels per level instead of
// four.
//
// Tiles.  A thread that walks its own block reads rows L apart from its
// neighbours', so the 32 threads of a warp would touch 32 cache lines per
// row.  The kernels that walk blocks instead stage the rows of the warp's
// 32 blocks in shared memory, loaded (or stored) 32 neighbouring rows at a
// time, with a row stride of L + 1 so that each thread's walk down its
// own block hits 32 different banks; the forward sweep overwrites each
// staged row with its c, h and g, which the back sweep reads.  The per-row
// scratch (R, C, VL, VR, Y) is laid out by row within the block, then
// block, so a warp's threads store neighbouring values.
//
// The operations, their order and the padding are those of
// ops/tridiag.py's partitioned_ref, which this route equals bit for bit.
// L and the depth depend on n only, so each column's bits are those of its
// solve alone.  At n = 10^6, m = 1 or 2: levels of 10^6, 31,250, 977 and
// 31 rows, 10 launches; each level's threads walk L - 1 dependent rows, so
// the reciprocal chain is ~30 long instead of 10^6.

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

// offdiag[i] of the padded system: 0 from row n-1 on.
template <typename T>
__device__ __forceinline__ T off_at(const T* __restrict__ e, long long i,
                                    long long n) {
  return i < n - 1 ? e[i] : T(0);
}

constexpr int kBlock = 32;         // L: ops/tridiag.py's BLOCK
constexpr int kInner = kBlock - 1;  // interior rows per block
constexpr int kTile = 32;          // blocks per tile: one warp, one each
constexpr int kPad = kBlock + 1;   // a staged block's row stride

// Rows row0 .. row0 + kTile * kBlock - 1 of at() into the tile s, row q at
// (q / kBlock) * kPad + q % kBlock: thread t's block starts at s[t * kPad].
// For a CUDA block of kTile threads; each issues its kBlock loads before
// its first store, so their latencies overlap.
template <typename T, typename F>
__device__ __forceinline__ void load_tile(T* s, long long row0, F at) {
  T v[kBlock];
#pragma unroll
  for (int u = 0; u < kBlock; ++u) v[u] = at(row0 + u * kTile + threadIdx.x);
#pragma unroll
  for (int u = 0; u < kBlock; ++u) {
    const int q = u * kTile + threadIdx.x;
    s[(q / kBlock) * kPad + q % kBlock] = v[u];
  }
}

// The per-row scratch of a level is laid out [L - 1, nb] (R, C, VL, VR)
// and [L - 1, nb, m] (Y): interior row j of every block is contiguous, so
// the threads of a warp, one block each, store neighbouring values.
// One thread per block, kTile to a CUDA block.
template <typename T>
__global__ void part_factor(const T* __restrict__ d, const T* __restrict__ e,
                            long long n, long long nb, T* __restrict__ R,
                            T* __restrict__ C, T* __restrict__ VL,
                            T* __restrict__ VR) {
  __shared__ T sd[kTile * kPad], se[kTile * kPad];
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
  load_tile(sd, k0 * kBlock, [&](long long i) { return i < n ? d[i] : T(1); });
  load_tile(se, k0 * kBlock, [&](long long i) { return off_at(e, i, n); });
  __syncthreads();
  const long long k = k0 + threadIdx.x;
  if (k >= nb) return;
  T* td = sd + threadIdx.x * kPad;  // d, then c
  T* te = se + threadIdx.x * kPad;  // e, then h
  const T e_left = k > 0 ? off_at(e, k * kBlock - 1, n) : T(0);
  T c_prev = T(0), h_prev = T(0), e_prev = T(0);
#pragma unroll
  for (int j = 0; j < kInner; ++j) {
    const T ej = te[j];
    const T r = T(1) / (td[j] - e_prev * c_prev);
    c_prev = ej * r;
    h_prev = ((j == 0 ? e_left : T(0)) - e_prev * h_prev) * r;
    R[j * nb + k] = r;
    C[j * nb + k] = c_prev;
    td[j] = c_prev;
    te[j] = h_prev;
    e_prev = ej;
  }
  T vl = te[kInner - 1], vr = td[kInner - 1];
  VL[(kInner - 1) * nb + k] = vl;
  VR[(kInner - 1) * nb + k] = vr;
#pragma unroll
  for (int j = kInner - 2; j >= 0; --j) {
    vl = te[j] - td[j] * vl;
    vr = -(td[j] * vr);
    VL[j * nb + k] = vl;
    VR[j * nb + k] = vr;
  }
}

// m = M of 1 or 2: part_factor and part_sweep in one pass, one thread
// per block for all M columns, b staged beside d and e; writes VL, VR and
// Y (R and C are not needed past the sweep).
template <typename T, int M>
__global__ void part_factor_sweep(const T* __restrict__ d,
                                  const T* __restrict__ e,
                                  const T* __restrict__ b, long long n,
                                  long long nb, T* __restrict__ VL,
                                  T* __restrict__ VR, T* __restrict__ Y) {
  __shared__ T sd[kTile * kPad], se[kTile * kPad], sb[M][kTile * kPad];
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
  load_tile(sd, k0 * kBlock, [&](long long i) { return i < n ? d[i] : T(1); });
  load_tile(se, k0 * kBlock, [&](long long i) { return off_at(e, i, n); });
#pragma unroll
  for (int col = 0; col < M; ++col) {
    load_tile(sb[col], k0 * kBlock,
              [&](long long i) { return i < n ? b[i * M + col] : T(0); });
  }
  __syncthreads();
  const long long k = k0 + threadIdx.x;
  if (k >= nb) return;
  T* td = sd + threadIdx.x * kPad;  // d, then c
  T* te = se + threadIdx.x * kPad;  // e, then h
  T* tb[M];                         // b, then g
#pragma unroll
  for (int col = 0; col < M; ++col) tb[col] = sb[col] + threadIdx.x * kPad;
  const T e_left = k > 0 ? off_at(e, k * kBlock - 1, n) : T(0);
  T c_prev = T(0), h_prev = T(0), e_prev = T(0), g_prev[M];
#pragma unroll
  for (int col = 0; col < M; ++col) g_prev[col] = T(0);
#pragma unroll
  for (int j = 0; j < kInner; ++j) {
    const T ej = te[j];
    const T r = T(1) / (td[j] - e_prev * c_prev);
    c_prev = ej * r;
    h_prev = ((j == 0 ? e_left : T(0)) - e_prev * h_prev) * r;
#pragma unroll
    for (int col = 0; col < M; ++col) {
      g_prev[col] = (tb[col][j] - e_prev * g_prev[col]) * r;
      tb[col][j] = g_prev[col];
    }
    td[j] = c_prev;
    te[j] = h_prev;
    e_prev = ej;
  }
  T vl = te[kInner - 1], vr = td[kInner - 1], y[M];
  VL[(kInner - 1) * nb + k] = vl;
  VR[(kInner - 1) * nb + k] = vr;
#pragma unroll
  for (int col = 0; col < M; ++col) {
    y[col] = tb[col][kInner - 1];
    Y[((kInner - 1) * nb + k) * M + col] = y[col];
  }
#pragma unroll
  for (int j = kInner - 2; j >= 0; --j) {
    const T c = td[j];
    vl = te[j] - c * vl;
    vr = -(c * vr);
    VL[j * nb + k] = vl;
    VR[j * nb + k] = vr;
#pragma unroll
    for (int col = 0; col < M; ++col) {
      y[col] = tb[col][j] - c * y[col];
      Y[(j * nb + k) * M + col] = y[col];
    }
  }
}

template <typename T>
__global__ void part_sweep(const T* __restrict__ e, const T* __restrict__ b,
                           const T* __restrict__ R, const T* __restrict__ C,
                           long long n, long long m, long long nb,
                           T* __restrict__ Y) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= nb * m) return;
  const long long k = t / m, col = t % m;
  const long long base = k * kBlock;
  T g[kInner];
  T g_prev = T(0), e_prev = T(0);
#pragma unroll
  for (int j = 0; j < kInner; ++j) {
    const long long i = base + j;
    const T bj = i < n ? b[i * m + col] : T(0);
    g_prev = (bj - e_prev * g_prev) * R[j * nb + k];
    g[j] = g_prev;
    e_prev = off_at(e, i, n);
  }
  T y = g[kInner - 1];
  Y[((kInner - 1) * nb + k) * m + col] = y;
#pragma unroll
  for (int j = kInner - 2; j >= 0; --j) {
    y = g[j] - C[j * nb + k] * y;
    Y[(j * nb + k) * m + col] = y;
  }
}

template <typename T>
__global__ void part_assemble(const T* __restrict__ d,
                              const T* __restrict__ e,
                              const T* __restrict__ b,
                              const T* __restrict__ Y,
                              const T* __restrict__ VL,
                              const T* __restrict__ VR, long long n,
                              long long m, long long nb, T* __restrict__ D,
                              T* __restrict__ E, T* __restrict__ B) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= nb * m) return;
  const long long k = t / m, col = t % m;
  const long long s = k * kBlock + kInner;    // the separator
  const long long last = (kInner - 1) * nb + k;  // block k's last interior row
  const bool next = k + 1 < nb;  // block k + 1's first row is k + 1
  const T e_r = off_at(e, s - 1, n), e_s = off_at(e, s, n);
  const T b_s = s < n ? b[s * m + col] : T(0);
  const T y_next = next ? Y[(k + 1) * m + col] : T(0);
  B[k * m + col] = (b_s - e_r * Y[last * m + col]) - e_s * y_next;
  if (col == 0) {
    const T d_s = s < n ? d[s] : T(1);
    const T vl_next = next ? VL[k + 1] : T(0);
    D[k] = (d_s - e_r * VR[last]) - e_s * vl_next;
    if (next) E[k] = -(e_s * VR[k + 1]);
  }
}

template <typename T>
__global__ void part_backfill(const T* __restrict__ X,
                              const T* __restrict__ Y,
                              const T* __restrict__ VL,
                              const T* __restrict__ VR, long long n,
                              long long m, long long nb, T* __restrict__ x) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n * m) return;
  const long long i = t / m, col = t % m;
  const long long k = i / kBlock, j = i % kBlock;
  if (j == kInner) {
    x[t] = X[k * m + col];
  } else {
    const long long r = j * nb + k;
    const T x_left = k > 0 ? X[(k - 1) * m + col] : T(0);
    x[t] = (Y[r * m + col] - x_left * VL[r]) - X[k * m + col] * VR[r];
  }
}

// m = M of 1 or 2: a transpose through a tile.  A CUDA block of
// kTile x kBlock threads covers kTile blocks: thread (c, j) computes row j
// of block k0 + c, reading the [L - 1, nb, M] scratch a warp-wide row at a
// time, into the tile; then each thread stores one of the tile's rows,
// 32 neighbouring rows to a warp.
template <typename T, int M>
__global__ void part_backfill_tile(const T* __restrict__ X,
                                   const T* __restrict__ Y,
                                   const T* __restrict__ VL,
                                   const T* __restrict__ VR, long long n,
                                   long long nb, T* __restrict__ x) {
  __shared__ T sx[M][kTile * kPad];
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
  const int c = threadIdx.x, j = threadIdx.y;
  const long long k = k0 + c;
  if (k < nb) {
    const long long r = j * nb + k;
#pragma unroll
    for (int col = 0; col < M; ++col) {
      const T x_right = X[k * M + col];
      T v = x_right;  // the separator, j = L - 1
      if (j < kInner) {
        const T x_left = k > 0 ? X[(k - 1) * M + col] : T(0);
        v = (Y[r * M + col] - x_left * VL[r]) - x_right * VR[r];
      }
      sx[col][c * kPad + j] = v;
    }
  }
  __syncthreads();
  const int q = j * kTile + c;
  const long long i = k0 * kBlock + q;
  if (i < n) {
#pragma unroll
    for (int col = 0; col < M; ++col) {
      x[i * M + col] = sx[col][(q / kBlock) * kPad + q % kBlock];
    }
  }
}

constexpr int kPartThreads = 256;

inline unsigned grid_for(long long threads) {
  return static_cast<unsigned>((threads + kPartThreads - 1) / kPartThreads);
}

inline unsigned tiles_for(long long blocks) {
  return static_cast<unsigned>((blocks + kTile - 1) / kTile);
}

template <typename T>
void thomas_launch(const T* d, const T* e, const T* b, T* cp, T* x, int n,
                   int m, cudaStream_t s) {
  thomas_kernel<T><<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      d, e, b, cp, x, n, m);
}

// One level's pointers; level 0's d, e, b, x are the caller's, a deeper
// level's are its parent's D, E, B, X.
template <typename T>
struct Level {
  const T* d;
  const T* e;
  const T* b;
  T* x;
  long long n;
  long long nb;
  T *R, *C, *VL, *VR, *Y;
};

constexpr int kMaxLevels = 32;

// Elements of scratch the route needs for n rows, m columns: per level of
// n_l > L rows (nb = ceil(n_l / L)): R, C, VL, VR of (L - 1) * nb, Y of
// (L - 1) * nb * m, D and E of nb, B and X of nb * m; then cp of
// n_base * m.
long long part_scratch(long long n, long long m) {
  long long total = 0;
  while (n > kBlock) {
    const long long nb = (n + kBlock - 1) / kBlock, rows = kInner * nb;
    total += 4 * rows + rows * m + 2 * nb + 2 * nb * m;
    n = nb;
  }
  return total + n * m;
}

// Launches the route; returns the number of kernels launched, or -1 if
// the levels do not fit.
template <typename T>
int part_run(const T* d, const T* e, const T* b, T* x, T* scratch, long long n,
             long long m, cudaStream_t s) {
  Level<T> lv[kMaxLevels];
  int depth = 0, launched = 0;
  lv[0] = Level<T>{d, e, b, x, n};
  T* p = scratch;
  while (lv[depth].n > kBlock) {
    if (depth + 1 >= kMaxLevels) return -1;
    Level<T>& cur = lv[depth];
    const long long nb = (cur.n + kBlock - 1) / kBlock, rows = kInner * nb;
    cur.nb = nb;
    cur.R = p;
    cur.C = p + rows;
    cur.VL = p + 2 * rows;
    cur.VR = p + 3 * rows;
    cur.Y = p + 4 * rows;
    T* D = cur.Y + rows * m;
    T* E = D + nb;
    T* B = E + nb;
    T* X = B + nb * m;
    p = X + nb * m;
    if (m == 1) {
      part_factor_sweep<T, 1><<<tiles_for(nb), kTile, 0, s>>>(
          cur.d, cur.e, cur.b, cur.n, nb, cur.VL, cur.VR, cur.Y);
      launched += 1;
    } else if (m == 2) {
      part_factor_sweep<T, 2><<<tiles_for(nb), kTile, 0, s>>>(
          cur.d, cur.e, cur.b, cur.n, nb, cur.VL, cur.VR, cur.Y);
      launched += 1;
    } else {
      part_factor<T><<<tiles_for(nb), kTile, 0, s>>>(
          cur.d, cur.e, cur.n, nb, cur.R, cur.C, cur.VL, cur.VR);
      part_sweep<T><<<grid_for(nb * m), kPartThreads, 0, s>>>(
          cur.e, cur.b, cur.R, cur.C, cur.n, m, nb, cur.Y);
      launched += 2;
    }
    part_assemble<T><<<grid_for(nb * m), kPartThreads, 0, s>>>(
        cur.d, cur.e, cur.b, cur.Y, cur.VL, cur.VR, cur.n, m, nb, D, E, B);
    launched += 1;
    lv[++depth] = Level<T>{D, E, B, X, nb};
  }
  const Level<T>& last = lv[depth];
  thomas_launch<T>(last.d, last.e, last.b, p, last.x,
                   static_cast<int>(last.n), static_cast<int>(m), s);
  launched += 1;
  for (int l = depth - 1; l >= 0; --l) {
    const Level<T>& cur = lv[l];
    if (m == 1) {
      part_backfill_tile<T, 1><<<tiles_for(cur.nb), dim3(kTile, kBlock), 0, s>>>(
          lv[l + 1].x, cur.Y, cur.VL, cur.VR, cur.n, cur.nb, cur.x);
    } else if (m == 2) {
      part_backfill_tile<T, 2><<<tiles_for(cur.nb), dim3(kTile, kBlock), 0, s>>>(
          lv[l + 1].x, cur.Y, cur.VL, cur.VR, cur.n, cur.nb, cur.x);
    } else {
      part_backfill<T><<<grid_for(cur.n * m), kPartThreads, 0, s>>>(
          lv[l + 1].x, cur.Y, cur.VL, cur.VR, cur.n, m, cur.nb, cur.x);
    }
    launched += 1;
  }
  return launched;
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

// Elements of scratch tridiag_part_launch needs (of the solve's type).
extern "C" long long tridiag_part_scratch(long long n, long long m) {
  return part_scratch(n, m);
}

// The partitioned route: diag [n], offdiag [n-1], rhs [n, m] and out x
// [n, m], all float32 (is_double 0) or float64 (1), contiguous; scratch of
// scratch_elems elements, at least tridiag_part_scratch(n, m).  Writes the
// number of kernels it launched to *launched.  Returns the CUDA error of
// the launches (0 on success), or -1 for scratch too small or too many
// levels.
extern "C" int tridiag_part_launch(const void* diag, const void* offdiag,
                                   const void* rhs, void* x, void* scratch,
                                   long long scratch_elems, long long n,
                                   long long m, int is_double, int* launched,
                                   void* stream) {
  *launched = 0;
  if (n <= 0 || m <= 0) return 0;
  if (scratch_elems < part_scratch(n, m)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = is_double
      ? part_run<double>(static_cast<const double*>(diag),
                         static_cast<const double*>(offdiag),
                         static_cast<const double*>(rhs),
                         static_cast<double*>(x), static_cast<double*>(scratch),
                         n, m, s)
      : part_run<float>(static_cast<const float*>(diag),
                        static_cast<const float*>(offdiag),
                        static_cast<const float*>(rhs), static_cast<float*>(x),
                        static_cast<float*>(scratch), n, m, s);
  if (k < 0) return -1;
  *launched = k;
  return static_cast<int>(cudaGetLastError());
}
