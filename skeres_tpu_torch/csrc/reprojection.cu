// The Snavely reprojection residual of bundle adjustment and its 2 x 12
// Jacobian, float32 or float64, one launch over a batch of observation
// rows:
//
//   P = R(aa) X + t,   (x, y) = -(P0, P1) / P2,   r2 = x^2 + y^2,
//   r = f (1 + r2 (k1 + k2 r2)) (x, y) - observation,
//   J = dr / d(aa, t, f, k1, k2, X)   (camera columns first),
//
// row b's camera (aa, t, f, k1, k2) and point X gathered from their tables
// by the row's two slot indices. J is the derivative of the port's own
// piecewise rotation (ops/rotation.py:angle_axis_rotate_point): Rodrigues
// where theta^2 >= 1e-12, else X + aa x X. ops/reprojection.py states the
// closed forms and holds the same formulas in PyTorch (the plain version).
// A residual-only mode writes each row's cost 0.5 |r|^2 and no Jacobian.
//
// Replaces no TPU kernel; the JAX package's evaluator is autodiff
// (skeres_tpu/core/evaluator.py: vmap of vjp, no pallas_call). Added
// because the port's evaluator, the same vmap of vjp in PyTorch, issued
// about 285 small launches a chunk of rows (88 for the cost alone), each
// writing whole (2, rows, 12) temporaries to device memory, where this
// kernel issues one.
//
// What bounds it on the card: bytes. A row reads its observation (2
// values), its two int64 slot indices, and its camera (9 values) and
// point (3) from the tables; it writes r (2 values) and J (24): about 240
// bytes a float64 row with the tables read once (7.07 GB, 2.1 ms at 3.35
// TB/s, for BAL Final's 28,987,644 rows; the residual-only mode writes 8
// bytes a row instead of 208: 1.27 GB). Its ~400 operations a row are a
// tenth of that time at float64's 34 TFLOP/s. So the design moves nothing
// else:
//
//   - one thread a row, 128 rows a block; every intermediate (the
//     rotation, the projection, dr/dP, the 24 values) stays in registers;
//   - the camera and the point are read through the read-only path: the
//     camera table (13,682 x 9 at Final, under 1 MB) stays in L2;
//   - J, 80 % of the bytes, is stored coalesced: each thread leaves its 24
//     values in shared memory (a row stride of 25, so that a warp's
//     threads fall on distinct banks), then the block writes its rows'
//     contiguous 128 x 24 values 16 bytes a thread, in order; r goes out
//     as one 16-byte (float32: 8-byte) store a row.
//
// The outputs are the caller's (the evaluator's batch outputs at a
// chunk's row offset), so nothing is copied after the launch.
//
// Plain C interface for ctypes: the function launches on the given
// stream, does not synchronize, allocates nothing, and returns the CUDA
// error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows a block, one a thread
constexpr int kJ = 24;      // a row's 2 x 12 Jacobian values
constexpr int kLd = 25;     // their row stride in shared memory: odd, so no bank conflicts

template <typename T>
struct Vec;  // the 16-byte store of J and the store of a row's residual pair
template <>
struct Vec<double> {
  using Wide = double2;  // two values
  using Pair = double2;
  static constexpr int kWide = 2;
  __device__ static Wide wide(const double* s) { return make_double2(s[0], s[1]); }
  __device__ static Pair pair(double a, double b) { return make_double2(a, b); }
};
template <>
struct Vec<float> {
  using Wide = float4;  // four values
  using Pair = float2;
  static constexpr int kWide = 4;
  __device__ static Wide wide(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
  __device__ static Pair pair(float a, float b) { return make_float2(a, b); }
};

__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float sine(float x) { return sinf(x); }

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> cross(const V3<T>& a, const V3<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ T dot(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// One row's residual and, where J is not null, its 24 Jacobian values
// (row-major 2 x 12).
template <typename T>
__device__ __forceinline__ void snavely_row(const T* __restrict__ c, const T* __restrict__ p,
                                            T u, T v, T* res, T* J) {
  const V3<T> aa{__ldg(c + 0), __ldg(c + 1), __ldg(c + 2)};
  const V3<T> X{__ldg(p + 0), __ldg(p + 1), __ldg(p + 2)};
  const T f = __ldg(c + 6), k1 = __ldg(c + 7), k2 = __ldg(c + 8);
  const T theta2 = dot(aa, aa);
  const bool small = theta2 < T(1e-12);
  T theta = T(1), s = T(0), co = T(1);
  V3<T> P;
  if (small) {  // first-order Rodrigues
    const V3<T> ax = cross(aa, X);
    P = {X.x + ax.x, X.y + ax.y, X.z + ax.z};
  } else {
    theta = root(theta2);
    sin_cos(theta, &s, &co);
    const T inv = T(1) / theta;
    const V3<T> w{aa.x * inv, aa.y * inv, aa.z * inv};
    const V3<T> wx = cross(w, X);
    const T k = (T(1) - co) * dot(w, X);
    P = {co * X.x + s * wx.x + k * w.x, co * X.y + s * wx.y + k * w.y,
         co * X.z + s * wx.z + k * w.z};
  }
  P.x += __ldg(c + 3);
  P.y += __ldg(c + 4);
  P.z += __ldg(c + 5);
  const T xp = -P.x / P.z, yp = -P.y / P.z;
  const T r2 = xp * xp + yp * yp;
  const T dist = T(1) + r2 * (k1 + k2 * r2);
  const T fd = f * dist;
  res[0] = fd * xp - u;
  res[1] = fd * yp - v;
  if (J == nullptr) return;

  // dr/d(x, y), then the rows g of dr/dP = dr/d(x, y) d(x, y)/dP
  const T dd = T(2) * (k1 + T(2) * k2 * r2);
  const T m00 = f * (dist + dd * xp * xp), m01 = f * (dd * xp * yp),
          m11 = f * (dist + dd * yp * yp);
  const T inv_z = T(-1) / P.z;
  const V3<T> g[2] = {{m00 * inv_z, m01 * inv_z, (m00 * xp + m01 * yp) * inv_z},
                      {m01 * inv_z, m11 * inv_z, (m01 * xp + m11 * yp) * inv_z}};
  T A = T(1), B = T(0), C = T(0), D = T(0);
  if (!small) {
    A = s / theta;
    const T h = sine(T(0.5) * theta);
    B = T(2) * h * h / theta2;  // (1 - cos) / theta^2 with its digits kept
    C = (co - A) / theta2;
    D = (A - T(2) * B) / theta2;
  }
  const V3<T> ax = cross(aa, X);
  const T ap = dot(aa, X);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const V3<T>& gi = g[i];
    T* Ji = J + 12 * i;
    const V3<T> xg = cross(X, gi), gxa = cross(gi, aa);
    const T ga = dot(gi, aa);
    if (small) {  // g (-[X]x) and g (I + [aa]x)
      Ji[0] = xg.x;
      Ji[1] = xg.y;
      Ji[2] = xg.z;
      Ji[9] = gi.x + gxa.x;
      Ji[10] = gi.y + gxa.y;
      Ji[11] = gi.z + gxa.z;
    } else {
      const T k = -A * dot(gi, X) + C * dot(gi, ax) + D * ap * ga;
      Ji[0] = k * aa.x + A * xg.x + B * (ga * X.x + ap * gi.x);
      Ji[1] = k * aa.y + A * xg.y + B * (ga * X.y + ap * gi.y);
      Ji[2] = k * aa.z + A * xg.z + B * (ga * X.z + ap * gi.z);
      const T bg = B * ga;
      Ji[9] = co * gi.x + A * gxa.x + bg * aa.x;
      Ji[10] = co * gi.y + A * gxa.y + bg * aa.y;
      Ji[11] = co * gi.z + A * gxa.z + bg * aa.z;
    }
    Ji[3] = gi.x;
    Ji[4] = gi.y;
    Ji[5] = gi.z;
    const T q = i == 0 ? xp : yp;
    Ji[6] = dist * q;
    Ji[7] = f * r2 * q;
    Ji[8] = f * r2 * r2 * q;
  }
}

template <typename T, bool kJacobian>
__global__ void __launch_bounds__(kRows)
    snavely_kernel(const T* __restrict__ cameras, const T* __restrict__ points,
                   const int64_t* __restrict__ cam, const int64_t* __restrict__ pt,
                   const T* __restrict__ obs, long n, T* __restrict__ r, T* __restrict__ jac,
                   T* __restrict__ cost) {
  __shared__ T stage[kJacobian ? kRows * kLd : 1];
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const long b = row0 + threadIdx.x;
  if (b < n) {
    T res[2];
    snavely_row<T>(cameras + 9 * cam[b], points + 3 * pt[b], obs[2 * b],
                   obs[2 * b + 1], res, kJacobian ? stage + threadIdx.x * kLd : nullptr);
    if constexpr (kJacobian) {
      reinterpret_cast<typename Vec<T>::Pair*>(r)[b] = Vec<T>::pair(res[0], res[1]);
    } else {
      cost[b] = T(0.5) * (res[0] * res[0] + res[1] * res[1]);
    }
  }
  if constexpr (kJacobian) {
    __syncthreads();
    // the block's rows of J are one contiguous range: store it in order
    constexpr int W = Vec<T>::kWide;
    const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
    auto* out = reinterpret_cast<typename Vec<T>::Wide*>(jac + row0 * kJ);
    for (int q = threadIdx.x; q < rows * (kJ / W); q += kRows) {
      const int e = q * W;  // W divides 24, so a store stays in one row
      out[q] = Vec<T>::wide(stage + (e / kJ) * kLd + e % kJ);
    }
  }
}

template <typename T>
int snavely(const void* cameras, const void* points, const void* cam, const void* pt,
            const void* obs, long n, void* r, void* jac, void* cost, void* stream) {
  if (n < 0 || (jac == nullptr) == (cost == nullptr) || (jac != nullptr && r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<blocks, kRows, 0, s>>>(
        static_cast<const T*>(cameras), static_cast<const T*>(points),
        static_cast<const int64_t*>(cam), static_cast<const int64_t*>(pt),
        static_cast<const T*>(obs), n, static_cast<T*>(r), static_cast<T*>(jac),
        static_cast<T*>(cost));
  };
  if (jac != nullptr) {
    args(snavely_kernel<T, true>);
  } else {
    args(snavely_kernel<T, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r (n, 2) and jac (n, 2, 12) where jac is given, else cost (n,).
#define SKERES_SNAVELY(NAME, T)                                                                 \
  extern "C" int NAME(const void* cameras, const void* points, const void* cam, const void* pt, \
                      const void* obs, long n, void* r, void* jac, void* cost, void* stream) {  \
    return snavely<T>(cameras, points, cam, pt, obs, n, r, jac, cost, stream);                 \
  }

SKERES_SNAVELY(skeres_snavely_f32, float)
SKERES_SNAVELY(skeres_snavely_f64, double)
