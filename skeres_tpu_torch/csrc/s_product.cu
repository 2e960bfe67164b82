// The implicit Schur-complement product on a camera-padded observation
// batch, float32 or float64: two passes over the Jacobian rows,
//
//   S v = (F^T F + D_f) v - W C^-1 W^T v,
//
//   point pass   wc_p  = s_e,p C_p^-1 sum_{rows r of point p} E_r^T (F_r v_cam(r))
//   camera pass  out_c = s_f,c sum_{rows r of camera c} F_r^T (F_r (s_f,c v_c) - E_r wc_p(r))
//   S v          = out + D_f v (added by the caller)
//
// with F_r (m x t) and E_r (m x e) a row's camera and point columns. The
// point pass reads the scaled rows in row order; the camera pass reads
// the rows placed camera by camera into the (cameras, K) grid of the
// camera-padded layout, unscaled where the minimizer reused them (then
// s_f and s_e conjugate the product), scaled otherwise (no s_f, s_e).
//
// Replaces no TPU kernel: the JAX package's padded product
// (skeres_tpu/core/schur.py:1268-1292) is plain jnp. Added because the
// port's product, about ten PyTorch ops that each wrote its whole
// intermediate to device memory ((rows, 2, 9) products of 4.5 GB among
// them), took 35.6 ms a call at BAL Final's shape (28,987,644 rows,
// float64) against 3.63 ms for the bytes it has to read, and PCG runs
// 2,300 of them a solve.
//
// What bounds it on the card: the bytes of the two passes. Each reads
// every Jacobian row once (192 B a float64 row of 2 x 12 values), plus
// an index a row; at Final about 6 GB a pass, about 2 operations per
// value read. So the design moves nothing else:
//
//   - one thread a row; a row's 2 x 12 values come in 16-byte loads and
//     every per-row intermediate (F v, E^T F v, the residual, F^T of it)
//     stays in registers;
//   - the camera's vector (13,682 x 9 at Final) and wc are gathered
//     from tables that stay in L2 or take one 32-byte sector a row: wc
//     is written 4 values wide for e = 3, so that one aligned load
//     fetches a point's 3;
//   - point pass: a block takes 128 consecutive points, whose rows are
//     one contiguous range (row order groups rows by point; a batch
//     that does not is read through a permutation sorted by point, both
//     planned once with the layout). Its threads take the range's rows
//     256 at a time, one a thread, and leave each row's E^T F v in shared
//     memory; each of the first 128 adds its point's rows in row order,
//     applies C_p^-1 and s_e, and writes wc: no (rows, ...) tensor, no
//     index_add_, no batched GEMV;
//   - camera pass: one block a camera, its threads striding over the
//     camera's placed rows that hold observations (the padding rows are
//     skipped), then a warp-shuffle tree and one sum over the warps;
//     s_f applied, the camera's sums written.
//
// A third kernel reads the camera pass's plan for the camera blocks of S
// (the SCHUR_JACOBI preconditioner, the diagonal blocks of the explicit S):
//
//   blocks       B_c = sum_{rows r of camera c} F_r^T (I - E_r (s_e C_p^-1 s_e) E_r^T) F_r
//
// (the caller scales by s_f on both sides; without C^-1, F^T F alone).
// Replaces no TPU kernel: the JAX package's padded blocks
// (skeres_tpu/core/schur.py:1146-1177) are plain jnp. Added because the
// port's blocks, batched GEMMs of 9 x 2 x 9 and 9 x 3 x 3 products that
// each wrote a (rows, 9, 9) or (rows, 9, 3) tensor, took about 0.5 s a
// damped solve at BAL Final's shape (float64, an H100), where this kernel
// takes 4.5 ms and the bytes it has to read 1.9 ms (2.6 ms counting each
// row's C_p^-1 and s_e gather). It is bound by the same bytes as the
// camera pass, plus that gather (four or five 32-byte sectors a row):
//
//   - one block a camera (128 threads, three blocks an SM), its threads
//     striding over the camera's placed rows that hold observations; a
//     row's 2 x 12 values come in 16-byte loads;
//   - per row, the m x m matrix M = I - E (s_e C^-1 s_e) E^T (3 values at
//     m = 2), then F^T M F added into the t(t+1)/2 upper entries of the
//     block (45 at t = 9), kept in registers: no (t, e) or (t, t)
//     intermediate leaves the thread;
//   - a warp-shuffle tree and one sum over the warps, then the symmetric
//     t x t block written whole. The instance whose sizes are read at run
//     time keeps its (up to 136) sums in shared memory, one warp a block.
//
// Every sum is taken in a fixed order (no atomics), so two calls on the
// same inputs agree bit for bit. Sums accumulate in the working type.
// (m, t, e) = (2, 9, 3) with the camera columns first (bundle adjustment)
// has an instance of its own sizes; any other shape up to (4, 16, 4)
// takes an instance whose sizes are read at run time.
//
// Plain C interface for ctypes: each function launches on the given
// stream, does not synchronize, allocates nothing, and returns the CUDA
// error of the launch (cudaErrorInvalidValue for sizes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;         // both kernels
constexpr int kPointsPerBlock = 128;  // point pass
constexpr int kMaxM = 4, kMaxT = 16, kMaxE = 4;  // the run-time instance's limits

// Sizes known at run time: m residuals a row of w = t + e values each, the
// camera columns at fc, the point columns at ec.
struct RunDims {
  int m, t, e, w, fc, ec;
  static constexpr int xm = kMaxM, xt = kMaxT, xe = kMaxE;
};

// Sizes fixed at compile time.
template <int M, int TF, int E, bool FFirst>
struct FixedDims {
  static constexpr int m = M, t = TF, e = E, w = TF + E;
  static constexpr int fc = FFirst ? 0 : E, ec = FFirst ? TF : 0;
  static constexpr int xm = M, xt = TF, xe = E;
};

template <class D>
constexpr bool kFixed = !std::is_same<D, RunDims>::value;

template <class D>
__device__ __forceinline__ D dims_of(const RunDims& rd) {
  if constexpr (kFixed<D>) {
    return D{};
  } else {
    return rd;
  }
}

// A row's values read from device memory one at a time (run-time sizes).
template <typename T>
struct GlobalRow {
  const T* p;
  int w;
  __device__ __forceinline__ T operator()(int i, int j) const { return p[i * w + j]; }
};

// A row's M * W values held in registers, loaded 16 or 8 bytes at a time
// where ``vec`` says the rows are aligned to that (compile-time sizes).
template <typename T, int M, int W>
struct RegRow {
  static constexpr int N = M * W;
  T v[N];
  __device__ __forceinline__ void load(const T* __restrict__ p, int vec) {
    if constexpr (std::is_same<T, double>::value) {
      if (N % 2 == 0 && vec == 16) {
        const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const double2 x = q[i];
          v[2 * i] = x.x;
          v[2 * i + 1] = x.y;
        }
        return;
      }
    } else {
      if (N % 4 == 0 && vec == 16) {
        const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 x = q[i];
          v[4 * i] = x.x;
          v[4 * i + 1] = x.y;
          v[4 * i + 2] = x.z;
          v[4 * i + 3] = x.w;
        }
        return;
      }
      if (N % 2 == 0 && vec >= 8) {
        const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float2 x = q[i];
          v[2 * i] = x.x;
          v[2 * i + 1] = x.y;
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
  __device__ __forceinline__ T operator()(int i, int j) const { return v[i * W + j]; }
};

// Apply ``fn`` to row ``p``'s accessor: its values in registers for fixed
// sizes, read from memory for run-time ones.
template <typename T, class D, class Fn>
__device__ __forceinline__ void with_row(const D& d, const T* __restrict__ p, int vec, Fn&& fn) {
  if constexpr (kFixed<D>) {
    RegRow<T, D::m, D::w> row;
    row.load(p, vec);
    fn(row);
  } else {
    fn(GlobalRow<T>{p, d.w});
  }
}

// The e values of point p in ``wc`` (row stride ldw): one aligned 16- or
// 32-byte load where ``wvec`` says the table is 4 wide and aligned.
template <typename T, class D>
__device__ __forceinline__ void load_wc(const D& d, const T* __restrict__ wc, long p, long ldw,
                                        int wvec, T (&w)[D::xe]) {
  const T* q = wc + p * ldw;
  if constexpr (kFixed<D>) {
    if constexpr (D::e == 3) {
      if (wvec) {
        if constexpr (std::is_same<T, double>::value) {
          const double2 a = reinterpret_cast<const double2*>(q)[0];
          const double2 b = reinterpret_cast<const double2*>(q)[1];
          w[0] = a.x;
          w[1] = a.y;
          w[2] = b.x;
        } else {
          const float4 a = reinterpret_cast<const float4*>(q)[0];
          w[0] = a.x;
          w[1] = a.y;
          w[2] = a.z;
        }
        return;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < D::xe; ++j) w[j] = j < d.e ? q[j] : T(0);
}

template <typename T, class D>
__global__ void __launch_bounds__(kThreads)
point_kernel(const T* __restrict__ rows, long ldr, int vec, RunDims rd,
             const int64_t* __restrict__ cam, const T* __restrict__ v,
             const int64_t* __restrict__ seg, const int64_t* __restrict__ perm, long n_pts,
             const T* __restrict__ cinv, const T* __restrict__ s_e, T* __restrict__ out,
             int ldo) {
  const D d = dims_of<D>(rd);
  __shared__ T s_val[kThreads * D::xe];  // one chunk's per-row E^T F v
  const int tid = threadIdx.x;
  const long p0 = static_cast<long>(blockIdx.x) * kPointsPerBlock;
  const int np = n_pts - p0 < kPointsPerBlock ? static_cast<int>(n_pts - p0) : kPointsPerBlock;
  const long lo = seg[p0], hi = seg[p0 + np];
  long a = 0, b = 0;  // the rows of this thread's point, where it has one
  if (tid < np) {
    a = seg[p0 + tid];
    b = seg[p0 + tid + 1];
  }
  T acc[D::xe];
#pragma unroll
  for (int j = 0; j < D::xe; ++j) acc[j] = 0;

  for (long c0 = lo; c0 < hi; c0 += kThreads) {
    const long q = c0 + tid;
    if (q < hi) {
      const long r = perm ? perm[q] : q;
      const T* vc = v + cam[r] * d.t;
      T fvc[D::xt];  // the row's camera vector
#pragma unroll
      for (int k = 0; k < D::xt; ++k) fvc[k] = k < d.t ? vc[k] : T(0);
      with_row<T>(d, rows + r * ldr, vec, [&](const auto& row) {
        T fv[D::xm];  // F v
#pragma unroll
        for (int i = 0; i < D::xm; ++i) {
          T s = 0;
#pragma unroll
          for (int k = 0; k < D::xt; ++k) {
            if (i < d.m && k < d.t) s += row(i, d.fc + k) * fvc[k];
          }
          fv[i] = s;
        }
#pragma unroll
        for (int j = 0; j < D::xe; ++j) {  // E^T (F v)
          T s = 0;
#pragma unroll
          for (int i = 0; i < D::xm; ++i) {
            if (i < d.m && j < d.e) s += row(i, d.ec + j) * fv[i];
          }
          s_val[tid * D::xe + j] = s;
        }
      });
    }
    __syncthreads();
    if (tid < np) {  // this point's rows inside the chunk, in row order
      const long from = a > c0 ? a : c0;
      const long to = b < c0 + kThreads ? b : c0 + kThreads;
      for (long k = from; k < to; ++k) {
#pragma unroll
        for (int j = 0; j < D::xe; ++j) acc[j] += s_val[(k - c0) * D::xe + j];
      }
    }
    __syncthreads();
  }

  if (tid < np) {
    const long p = p0 + tid;
    T w[D::xe];
    if (cinv) {  // C_p^-1 (E^T F v)
      const T* c = cinv + p * d.e * d.e;
#pragma unroll
      for (int j = 0; j < D::xe; ++j) {
        T s = 0;
#pragma unroll
        for (int l = 0; l < D::xe; ++l) {
          if (j < d.e && l < d.e) s += c[j * d.e + l] * acc[l];
        }
        w[j] = s;
      }
    } else {
#pragma unroll
      for (int j = 0; j < D::xe; ++j) w[j] = acc[j];
    }
    T* o = out + p * ldo;
#pragma unroll
    for (int j = 0; j < D::xe; ++j) {
      if (j < d.e) o[j] = s_e ? w[j] * s_e[p * d.e + j] : w[j];
    }
    for (int j = d.e; j < ldo; ++j) o[j] = 0;
  }
}

template <typename T, class D>
__global__ void __launch_bounds__(kThreads)
camera_kernel(const T* __restrict__ rows, long ldr, int vec, RunDims rd,
              const int64_t* __restrict__ pidx, const int64_t* __restrict__ counts, long K,
              const T* __restrict__ v, const T* __restrict__ s_f, const T* __restrict__ wc,
              long ldw, int wvec, T* __restrict__ out) {
  const D d = dims_of<D>(rd);
  __shared__ T s_red[kThreads / 32][D::xt];
  const long c = blockIdx.x;
  const int tid = threadIdx.x;
  T vin[D::xt];  // s_f v of this camera
#pragma unroll
  for (int k = 0; k < D::xt; ++k) {
    T x = 0;
    if (k < d.t) {
      x = v[c * d.t + k];
      if (s_f) x *= s_f[c * d.t + k];
    }
    vin[k] = x;
  }
  T acc[D::xt];
#pragma unroll
  for (int k = 0; k < D::xt; ++k) acc[k] = 0;

  const long n = counts ? counts[c] : K;
  const T* base = rows + c * K * ldr;
  const int64_t* pc = pidx + c * K;
  for (long j = tid; j < n; j += kThreads) {
    T w[D::xe];
    load_wc<T>(d, wc, pc[j], ldw, wvec, w);
    with_row<T>(d, base + j * ldr, vec, [&](const auto& row) {
      T res[D::xm];  // F (s_f v) - E wc
#pragma unroll
      for (int i = 0; i < D::xm; ++i) {
        T fv = 0, ew = 0;
#pragma unroll
        for (int k = 0; k < D::xt; ++k) {
          if (i < d.m && k < d.t) fv += row(i, d.fc + k) * vin[k];
        }
#pragma unroll
        for (int l = 0; l < D::xe; ++l) {
          if (i < d.m && l < d.e) ew += row(i, d.ec + l) * w[l];
        }
        res[i] = fv - ew;
      }
#pragma unroll
      for (int k = 0; k < D::xt; ++k) {  // F^T res
        T s = 0;
#pragma unroll
        for (int i = 0; i < D::xm; ++i) {
          if (i < d.m && k < d.t) s += row(i, d.fc + k) * res[i];
        }
        acc[k] += s;
      }
    });
  }

  // the block's sum: a butterfly in each warp, then the warps in order
#pragma unroll
  for (int k = 0; k < D::xt; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < D::xt; ++k) s_red[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < d.t) {
    T s = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += s_red[i][tid];
    const long o = c * d.t + tid;
    out[o] = s_f ? s * s_f[o] : s;
  }
}

// The t(t+1)/2 upper entries of a thread's block sums: registers where the
// sizes are fixed; where they are read at run time, this thread's column
// of a table in shared memory (up to 136 sums a thread, which registers
// cannot hold in float64).
constexpr int kRunThreads = 32;  // the camera blocks' run-time instance: one warp a block
// the camera blocks' (2, 9, 3) instance: at its 139 registers a thread (float64)
// three blocks share an SM, where one of 256 threads fills it alone (venice's
// shape 0.66 ms against 0.74, Final's 4.52 against 4.59, on an H100)
constexpr int kBlocksFixedThreads = 128;

template <typename T, class D>
struct BlockSums {
  T v[D::t * (D::t + 1) / 2];
  __device__ __forceinline__ T& operator()(int q) { return v[q]; }
};

template <typename T>
struct BlockSums<T, RunDims> {
  T* p;
  __device__ __forceinline__ T& operator()(int q) { return p[q * kRunThreads]; }
};

template <class D>
constexpr int kBlocksThreads = kFixed<D> ? kBlocksFixedThreads : kRunThreads;

template <typename T, class D>
__global__ void __launch_bounds__(kBlocksThreads<D>)
blocks_kernel(const T* __restrict__ rows, long ldr, int vec, RunDims rd,
              const int64_t* __restrict__ pidx, const int64_t* __restrict__ counts, long K,
              const T* __restrict__ cinv, const T* __restrict__ s_e, T* __restrict__ out) {
  constexpr int NT = kBlocksThreads<D>;
  constexpr int XQ = D::xt * (D::xt + 1) / 2;  // the most upper entries
  const D d = dims_of<D>(rd);
  const int nq = d.t * (d.t + 1) / 2;
  __shared__ T s_red[NT / 32][XQ];
  __shared__ T s_sums[kFixed<D> ? 1 : XQ * NT];
  const long c = blockIdx.x;
  const int tid = threadIdx.x;
  BlockSums<T, D> acc;
  if constexpr (!kFixed<D>) acc.p = s_sums + tid;
#pragma unroll
  for (int q = 0; q < XQ; ++q) {
    if (q < nq) acc(q) = 0;
  }

  const long n = counts[c];
  const T* base = rows + c * K * ldr;
  const int64_t* pc = pidx + c * K;
  for (long j = tid; j < n; j += NT) {
    T cs[D::xe][D::xe];  // s_e C_p^-1 s_e of the row's point
    if (cinv) {
      const long p = pc[j];
      const T* cp = cinv + p * d.e * d.e;
      const T* sp = s_e ? s_e + p * d.e : nullptr;
#pragma unroll
      for (int a = 0; a < D::xe; ++a) {
#pragma unroll
        for (int b = 0; b < D::xe; ++b) {
          T x = 0;
          if (a < d.e && b < d.e) {
            x = cp[a * d.e + b];
            if (sp) x = x * sp[a] * sp[b];
          }
          cs[a][b] = x;
        }
      }
    }
    with_row<T>(d, base + j * ldr, vec, [&](const auto& row) {
      T mm[D::xm][D::xm];  // M = I - E cs E^T, symmetric
#pragma unroll
      for (int i = 0; i < D::xm; ++i) {
        T g[D::xe];  // row i of E cs
#pragma unroll
        for (int l = 0; l < D::xe; ++l) {
          T s = 0;
#pragma unroll
          for (int a = 0; a < D::xe; ++a) {
            if (cinv && i < d.m && a < d.e && l < d.e) s += row(i, d.ec + a) * cs[a][l];
          }
          g[l] = s;
        }
#pragma unroll
        for (int k = i; k < D::xm; ++k) {
          T s = 0;
#pragma unroll
          for (int l = 0; l < D::xe; ++l) {
            if (cinv && k < d.m && l < d.e) s += g[l] * row(k, d.ec + l);
          }
          mm[i][k] = (i == k ? T(1) : T(0)) - s;
          mm[k][i] = mm[i][k];
        }
      }
      T h[D::xm][D::xt];  // M F
#pragma unroll
      for (int i = 0; i < D::xm; ++i) {
#pragma unroll
        for (int b = 0; b < D::xt; ++b) {
          T s = 0;
#pragma unroll
          for (int k = 0; k < D::xm; ++k) {
            if (i < d.m && k < d.m && b < d.t) s += mm[i][k] * row(k, d.fc + b);
          }
          h[i][b] = s;
        }
      }
      int q = 0;  // F^T (M F), the upper entries row by row
#pragma unroll
      for (int a = 0; a < D::xt; ++a) {
#pragma unroll
        for (int b = a; b < D::xt; ++b) {
          if (b < d.t) {
            T s = 0;
#pragma unroll
            for (int i = 0; i < D::xm; ++i) {
              if (i < d.m) s += row(i, d.fc + a) * h[i][b];
            }
            acc(q) += s;
            ++q;
          }
        }
      }
    });
  }

  // the block's sums: a butterfly in each warp, then the warps in order
  const int warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < XQ; ++q) {
    if (q < nq) {
      T x = acc(q);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if ((tid & 31) == 0) s_red[warp][q] = x;
    }
  }
  __syncthreads();
  T* o = out + c * d.t * d.t;
  for (int q = tid; q < nq; q += NT) {
    T s = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += s_red[w][q];
    int a = 0, first = 0;  // entry q is (a, b), b >= a
    while (q >= first + d.t - a) {
      first += d.t - a;
      ++a;
    }
    const int b = a + q - first;
    o[a * d.t + b] = s;
    o[b * d.t + a] = s;
  }
}

bool dims_ok(int m, int t, int e) {
  return m >= 1 && m <= kMaxM && t >= 1 && t <= kMaxT && e >= 1 && e <= kMaxE;
}

RunDims run_dims(int m, int t, int e, int f_first) {
  return RunDims{m, t, e, t + e, f_first ? 0 : e, f_first ? t : 0};
}

bool is_ba(int m, int t, int e, int f_first) { return m == 2 && t == 9 && e == 3 && f_first; }

using BA = FixedDims<2, 9, 3, true>;

template <typename T>
int point_sums(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,
               const void* cam, const void* v, const void* seg, const void* perm, long n_pts,
               const void* cinv, const void* s_e, void* out, int ldo, void* stream) {
  if (!dims_ok(m, t, e) || n_pts < 0 || ldo < e) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const RunDims rd = run_dims(m, t, e, f_first);
  const unsigned blocks = static_cast<unsigned>((n_pts + kPointsPerBlock - 1) / kPointsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(rows), ldr, vec, rd, static_cast<const int64_t*>(cam),
        static_cast<const T*>(v), static_cast<const int64_t*>(seg),
        static_cast<const int64_t*>(perm), n_pts, static_cast<const T*>(cinv),
        static_cast<const T*>(s_e), static_cast<T*>(out), ldo);
  };
  if (is_ba(m, t, e, f_first)) {
    launch(point_kernel<T, BA>);
  } else {
    launch(point_kernel<T, RunDims>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int camera_sums(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,
                const void* pidx, const void* counts, long nc, long K, const void* v,
                const void* s_f, const void* wc, long ldw, int wvec, void* out, void* stream) {
  if (!dims_ok(m, t, e) || nc < 0 || K < 1 || ldw < e) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nc == 0) return 0;
  const RunDims rd = run_dims(m, t, e, f_first);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(nc), kThreads, 0, s>>>(
        static_cast<const T*>(rows), ldr, vec, rd, static_cast<const int64_t*>(pidx),
        static_cast<const int64_t*>(counts), K, static_cast<const T*>(v),
        static_cast<const T*>(s_f), static_cast<const T*>(wc), ldw, wvec, static_cast<T*>(out));
  };
  if (is_ba(m, t, e, f_first)) {
    launch(camera_kernel<T, BA>);
  } else {
    launch(camera_kernel<T, RunDims>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int camera_blocks(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,
                  const void* pidx, const void* counts, long nc, long K, const void* cinv,
                  const void* s_e, void* out, void* stream) {
  if (!dims_ok(m, t, e) || nc < 0 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return 0;
  const RunDims rd = run_dims(m, t, e, f_first);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int threads) {
    kernel<<<static_cast<unsigned>(nc), threads, 0, s>>>(
        static_cast<const T*>(rows), ldr, vec, rd, static_cast<const int64_t*>(pidx),
        static_cast<const int64_t*>(counts), K, static_cast<const T*>(cinv),
        static_cast<const T*>(s_e), static_cast<T*>(out));
  };
  if (is_ba(m, t, e, f_first)) {
    launch(blocks_kernel<T, BA>, kBlocksThreads<BA>);
  } else {
    launch(blocks_kernel<T, RunDims>, kBlocksThreads<RunDims>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SKERES_S_POINT(NAME, T)                                                               \
  extern "C" int NAME(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,  \
                      const void* cam, const void* v, const void* seg, const void* perm,      \
                      long n_pts, const void* cinv, const void* s_e, void* out, int ldo,      \
                      void* stream) {                                                         \
    return point_sums<T>(rows, ldr, vec, m, t, e, f_first, cam, v, seg, perm, n_pts, cinv,    \
                         s_e, out, ldo, stream);                                              \
  }
#define SKERES_S_CAMERA(NAME, T)                                                              \
  extern "C" int NAME(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,  \
                      const void* pidx, const void* counts, long nc, long K, const void* v,   \
                      const void* s_f, const void* wc, long ldw, int wvec, void* out,         \
                      void* stream) {                                                         \
    return camera_sums<T>(rows, ldr, vec, m, t, e, f_first, pidx, counts, nc, K, v, s_f, wc,  \
                          ldw, wvec, out, stream);                                            \
  }

#define SKERES_S_BLOCKS(NAME, T)                                                              \
  extern "C" int NAME(const void* rows, long ldr, int vec, int m, int t, int e, int f_first,  \
                      const void* pidx, const void* counts, long nc, long K,                  \
                      const void* cinv, const void* s_e, void* out, void* stream) {           \
    return camera_blocks<T>(rows, ldr, vec, m, t, e, f_first, pidx, counts, nc, K, cinv,      \
                            s_e, out, stream);                                                \
  }

SKERES_S_POINT(skeres_s_point_f32, float)
SKERES_S_POINT(skeres_s_point_f64, double)
SKERES_S_CAMERA(skeres_s_camera_f32, float)
SKERES_S_CAMERA(skeres_s_camera_f64, double)
SKERES_S_BLOCKS(skeres_s_blocks_f32, float)
SKERES_S_BLOCKS(skeres_s_blocks_f64, double)
