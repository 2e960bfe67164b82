// K3: explicit-Schur pair products, float32 or float64.
//
// For every point p, with its kp observation slots laid on a grid row of
// A = F^T E blocks (f x e each, f-major: column k*f*e + i*e + j holds
// A_pk[i][j]) and its C_p^-1 (e x e):
//
//   Y_pk = A_pk C_p^-1                      for every slot k
//   T    = Y_pk A_pl^T   (f x f)            for every slot pair (k, l), k < l
//
// stored in canonical camera order (T^T where the pair's swap flag is set)
// and zeroed where the pair is not valid. Output row p * npairs + n holds
// pair n of point p as f*f values, f-major (row i of T, then row i + 1):
// the form of ExplicitSchurPlan._chunk_vals in the JAX package.
//
// Replaces skeres_tpu/ops/pallas/pair_product.py:_pair_kernel (through
// pair_products_lanes). That kernel puts the points on the TPU's 128
// vector lanes and the tiny (f, e) minors on the sublanes, to fill the
// TPU's (8, 128) tiles, and writes g-major rows. Hopper has no such tiles;
// what bounds this computation here is the output: npairs * f * f values
// per point against 3 multiply-adds each (at venice-1778 shape, 10M pair
// rows of 81 float32 = 3.24 GB written, against ~0.6 GB read). So:
//
//   - one block of 256 threads takes a tile of consecutive points; their
//     grid rows, C^-1 blocks and pair flags are contiguous in device
//     memory and come into shared memory with coalesced loads;
//   - the block forms Y for the tile in shared memory;
//   - its threads then walk the tile's output in memory order, one value
//     per thread per step, each a 3-term dot product of two shared rows:
//     every warp stores 32 consecutive values, so the 3.24 GB go out fully
//     coalesced. Only the loop over the tile's first point index divides
//     by a runtime value; f and e are template parameters.
//
// The caller chooses the tile (ops/pair_product.py): as many points as fit
// a 40 KB shared-memory budget, at most 64. At f = 9, e = 3, kp = 5 in
// float32 a point takes 1126 bytes, so the tile is 36 points and 40,616
// bytes, under the 48 KB that needs no opt-in, which leaves room for
// several blocks on each SM to overlap one block's loads with another's
// stores.
//
// Plain C interface for ctypes: each function launches on the given stream,
// does not synchronize, and returns the CUDA error of the launch
// (cudaErrorInvalidValue for an (f, e) that has no instance here).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int F, int E>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const T* __restrict__ grid, const T* __restrict__ cinv,
            const uint8_t* __restrict__ swap, const uint8_t* __restrict__ valid,
            const int* __restrict__ pair_kl, T* __restrict__ out,
            long num_points, int kp, int npairs, int tile) {
  constexpr int FE = F * E;
  constexpr int FF = F * F;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kfe = kp * FE;
  T* s_a = reinterpret_cast<T*>(smem);  // tile x kp x F x E
  T* s_y = s_a + tile * kfe;            // the same layout
  T* s_c = s_y + tile * kfe;            // tile x E x E
  int* s_k = reinterpret_cast<int*>(s_c + tile * E * E);
  int* s_l = s_k + npairs;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_l + npairs);  // bit 0 valid, bit 1 swap

  const long p0 = static_cast<long>(blockIdx.x) * tile;
  const int np = num_points - p0 < tile ? static_cast<int>(num_points - p0) : tile;
  const int tid = threadIdx.x;

  const T* g = grid + p0 * kfe;
  for (int i = tid; i < np * kfe; i += kThreads) s_a[i] = g[i];
  const T* c = cinv + p0 * (E * E);
  for (int i = tid; i < np * E * E; i += kThreads) s_c[i] = c[i];
  for (int i = tid; i < npairs; i += kThreads) {
    s_k[i] = pair_kl[i];
    s_l[i] = pair_kl[npairs + i];
  }
  const uint8_t* va = valid + p0 * npairs;
  const uint8_t* sw = swap + p0 * npairs;
  for (int i = tid; i < np * npairs; i += kThreads) {
    s_flag[i] = (va[i] ? 1 : 0) | (sw[i] ? 2 : 0);
  }
  __syncthreads();

  // Y[p][k][i][j] = sum_t A[p][k][i][t] C[p][t][j], one value per thread
  for (int idx = tid; idx < np * kfe; idx += kThreads) {
    const int row = idx / E;  // (p * kp + k) * F + i
    const int j = idx - row * E;
    const T* a_row = s_a + row * E;
    const T* c_p = s_c + (idx / kfe) * (E * E);
    T acc = 0;
#pragma unroll
    for (int t = 0; t < E; ++t) acc += a_row[t] * c_p[t * E + j];
    s_y[idx] = acc;
  }
  __syncthreads();

  // the tile's output rows, in memory order: idx = p * npff + n * FF + i * F + j
  const int npff = npairs * FF;
  T* o = out + p0 * npff;
  int p = tid / npff;
  int r = tid - p * npff;
  for (int idx = tid; idx < np * npff; idx += kThreads) {
    const int n = r / FF;
    const int q = r - n * FF;
    const int i = q / F;
    const int j = q - i * F;
    const uint8_t flag = s_flag[p * npairs + n];
    T v = 0;
    if (flag & 1) {
      // T[i][j] = sum_t Y_k[i][t] A_l[j][t]; swapped, T^T[i][j] = T[j][i]
      const int ry = (flag & 2) ? j : i;
      const int ra = (flag & 2) ? i : j;
      const T* y = s_y + ((p * kp + s_k[n]) * F + ry) * E;
      const T* a = s_a + ((p * kp + s_l[n]) * F + ra) * E;
#pragma unroll
      for (int t = 0; t < E; ++t) v += y[t] * a[t];
    }
    o[idx] = v;
    r += kThreads;
    while (r >= npff) {
      r -= npff;
      ++p;
    }
  }
}

template <typename T, int F, int E>
int launch(const void* grid, const void* cinv, const void* swap, const void* valid,
           const void* pair_kl, void* out, long num_points, int kp, int npairs, int tile,
           void* stream) {
  const size_t smem = static_cast<size_t>(tile) * (2 * kp * F * E + E * E) * sizeof(T) +
                      static_cast<size_t>(npairs) * 2 * sizeof(int) +
                      static_cast<size_t>(tile) * npairs;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_kernel<T, F, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = (num_points + tile - 1) / tile;
  pair_kernel<T, F, E><<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(grid), static_cast<const T*>(cinv),
      static_cast<const uint8_t*>(swap), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(pair_kl), static_cast<T*>(out), num_points, kp, npairs, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* grid, const void* cinv, const void* swap, const void* valid,
             const void* pair_kl, void* out, long num_points, int kp, int npairs, int f,
             int e, int tile, void* stream) {
  if (num_points < 1 || kp < 2 || npairs < 1 || tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f == 9 && e == 3) {  // bundle adjustment: 9 camera, 3 point parameters
    return launch<T, 9, 3>(grid, cinv, swap, valid, pair_kl, out, num_points, kp, npairs,
                           tile, stream);
  }
  if (f == 5 && e == 3) {  // the tests' shape
    return launch<T, 5, 3>(grid, cinv, swap, valid, pair_kl, out, num_points, kp, npairs,
                           tile, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int skeres_pair_products_f32(const void* grid, const void* cinv, const void* swap,
                                        const void* valid, const void* pair_kl, void* out,
                                        long num_points, int kp, int npairs, int f, int e,
                                        int tile, void* stream) {
  return dispatch<float>(grid, cinv, swap, valid, pair_kl, out, num_points, kp, npairs, f, e,
                         tile, stream);
}

extern "C" int skeres_pair_products_f64(const void* grid, const void* cinv, const void* swap,
                                        const void* valid, const void* pair_kl, void* out,
                                        long num_points, int kp, int npairs, int f, int e,
                                        int tile, void* stream) {
  return dispatch<double>(grid, cinv, swap, valid, pair_kl, out, num_points, kp, npairs, f, e,
                          tile, stream);
}
