// K1: dense Cholesky factor L and its explicit inverse X = L^-1 of one SPD
// matrix A (n x n, row-major, 1 <= n <= 1024), float32 or float64; and
// K2's trailing update C -= tril(P P^T), the lower-triangle rank-w update
// of the blocked factor past 1024 rows.
//
// K1 replaces skeres_tpu/ops/pallas/cholesky.py:_chol_inv_kernel, which keeps
// the whole matrix in TPU VMEM. A 441^2 float32 matrix is 778 KB against
// 227 KB of shared memory a block, so here L and X are worked on in place
// in device memory (<= 8 MB each, L2-resident) by ONE cluster of 8 CTAs of
// 512 threads, one an SM, launched once. Each CTA keeps a copy of one block
// column in shared memory. Factor and inverse go together, right-looking,
// W columns a step (W = 32 in float32, 16 in float64):
//
//   diagonal  every CTA's warp 0 factors the W x W diagonal block (lane r
//             holds row r in registers; columns pass through shared
//             memory, one __syncwarp a column, no block barrier) and forms
//             its inverse (lane c holds column c). The same input gives the
//             same result in every CTA, so nothing is exchanged.
//   multiply  the panel below, L[i, J] = A[i, J] Ljj^-T, and block row J of
//             X, X[J, c] = Ljj^-1 B[J, c] (B the rows as the earlier steps
//             left them), are one product with Ljj^-1, 4 threads a column
//             or row, each CTA one chunk of them. Both land in Q, an
//             (n x W) array in shared memory: Q[c] = X[J, c]^T for
//             c < J + W, Q[c] = L[c, J] past it. A cluster barrier, then
//             each CTA copies the others' chunks of Q through distributed
//             shared memory.
//   update    every later row i takes one rank-W update of its lower part,
//             M[i][c] -= Q[i] . Q[c] for c <= i, where M is X left of
//             column J + W and L from there on: the trailing factor update
//             and the inverse update in one pass, on the tensor cores
//             (mma.sync; float32 as 3xTF32, float64 as DMMA), 32 x 32 tiles
//             dealt to the cluster's 128 warps. A cluster barrier ends it.
//
// Two cluster barriers a step, none a column. What bounds it: the chain of
// a step (the diagonal block's W dependent columns, ~6 us, then two cluster
// barriers) at n <= 512, and the update's read-modify-write of M through
// L2 at larger n (the clock64 breakdown in PERF.md).
//
// The trailing update replaces the second jnp.dot of
// skeres_tpu/ops/pallas/cholesky.py:_blocked_factor_padded (at
// Precision.HIGH, bf16_3x). Over a 16,002-row factor it is ~1.4 TFLOP, the
// largest single cost of K2. A grid of 128 x 128 tiles of C on and below the
// diagonal (a triangular tile index: the upper triangle is neither computed
// nor touched), the P tiles streamed through a three-stage cp.async ring.
// float32 runs 3xTF32 on wgmma: each operand splits into hi = tf32(x) and
// lo = x - hi, and the tensor cores accumulate lo.hi + hi.lo + hi.hi in
// float32, which keeps float32-level accuracy (one TF32 pass keeps about
// three digits); A reaches them from registers, B from shared memory, and
// the C tile is read into registers while the main loop runs. float64 runs
// DMMA (mma.sync m8n8k4). What bounds it: ~180 TF32 TFLOP/s at w = 512, a
// third of the card's peak; the three passes' shared-memory traffic and the
// split are the suspects (PERF.md).
//
// Failure contract of K1: a pivot that is not positive and finite makes
// every element of L and L^-1 NaN. (The TPU kernel clamps the pivot to the
// smallest normal number instead, which can leave a finite factor.)
//
// Compiled with -DSKERES_K1_CLOCKS, K1 also sums clock64() cycles of CTA
// 0's thread 0 by phase (set-up, diagonal, multiply, exchange: the cluster
// barrier and the gather of Q, update, the closing cluster barrier, NaN
// fill) into a device array that skeres_k1_clocks() reads and clears.
//
// Plain C interface for ctypes: each launcher runs on the given stream, does
// not synchronize, and returns the CUDA error of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 1024;
constexpr int kK1Threads = 512;
constexpr int kTile = 32;  // K1's update tile: one warp, 32 x 32

// --- tensor-core steps ---------------------------------------------------------
//
// Both products read A (rows x depth) and B (cols x depth) from shared memory
// with the depth contiguous, and accumulate acc[mt][nt] += A B^T for the
// warp's tile of kRows * MT rows and 8 * NT columns. Accumulator element e
// of (mt, nt) sits at row mt * kRows + lane / 4 + 8 * (e / 2), column
// nt * 8 + 2 * (lane % 4) + e % 2.

template <typename T>
struct Tc;
template <>
struct Tc<float> {  // mma.m16n8k8 TF32, three passes
  static constexpr int kRows = 16, kAcc = 4;
};
template <>
struct Tc<double> {  // mma.m8n8k4 f64
  static constexpr int kRows = 8, kAcc = 2;
};

// hi = x rounded to TF32 (to nearest, ties away: add half of the 13 dropped
// bits, then clear them; two integer operations), lo = x - hi exact, passed
// whole: the tensor core reads its top 19 bits, |lo - tf32(lo)| < 2^-10 |lo|.
// A NaN x may round to a zero or an infinite hi, but its lo is NaN and
// carries it into the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// float32, 3xTF32: lo.hi + hi.lo + hi.hi for every k8 step; Depth % 8 == 0
template <int MT, int NT, int Depth>
__device__ __forceinline__ void warp_mma(const float* a, const float* b, int ld,
                                         float (&acc)[MT][NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < Depth; k += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* p = b + (nt * 8 + g) * ld + k + t;
      split_tf32(p[0], bh[nt][0], bl[nt][0]);
      split_tf32(p[4], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = a + (mt * 16 + g) * ld + k + t;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * ld], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * ld + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
        mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);
        mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
      }
    }
  }
}

// float64, DMMA; Depth % 4 == 0
template <int MT, int NT, int Depth>
__device__ __forceinline__ void warp_mma(const double* a, const double* b, int ld,
                                         double (&acc)[MT][NT][2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < Depth; k += 4) {
    double bv[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bv[nt] = b[(nt * 8 + g) * ld + k + t];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const double av = a[(mt * 8 + g) * ld + k + t];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_f64(acc[mt][nt], av, bv[nt]);
    }
  }
}

template <typename T, int MT, int NT>
__device__ __forceinline__ void zero(T (&acc)[MT][NT][Tc<T>::kAcc]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < Tc<T>::kAcc; ++e) acc[mt][nt][e] = T(0);
}

// --- K1 ----------------------------------------------------------------------------

constexpr int kK1Cluster = 8;  // CTAs of K1's one cluster, one an SM
constexpr int kSplit = 4;      // threads a column in the multiply step

template <typename T>
struct K1Width;
template <>
struct K1Width<float> { static constexpr int value = 32; };
template <>
struct K1Width<double> { static constexpr int value = 16; };

// Q's row stride: W + 4 values (144 bytes in float32, 160 in float64), so
// that the tensor-core fragment loads are free of bank conflicts.
template <typename T>
__host__ __device__ constexpr int q_stride() { return K1Width<T>::value + 4; }

// Q holds n rows and a zero tail of kTile rows that update tiles may read
template <typename T>
__host__ __device__ inline size_t k1_smem_bytes(int n) {
  return static_cast<size_t>(n + kTile) * q_stride<T>() * sizeof(T);
}

#ifdef SKERES_K1_CLOCKS
__device__ unsigned long long k1_clocks[7];
#define K1_MARK(slot)                                                 \
  if (tid == 0 && rank == 0) {                                        \
    const long long now = clock64();                                  \
    k1_clocks[slot] += static_cast<unsigned long long>(now - mark);   \
    mark = now;                                                       \
  }
#else
#define K1_MARK(slot)
#endif

template <typename T>
__global__ void __cluster_dims__(kK1Cluster, 1, 1) __launch_bounds__(kK1Threads, 1)
chol_inv_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ x, int n) {
  constexpr int W = K1Width<T>::value;
  constexpr int QS = q_stride<T>();
  constexpr int MT = kTile / Tc<T>::kRows;
  constexpr int NT = kTile / 8;
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* q = reinterpret_cast<T*>(smem);
  __shared__ T col[W][W];       // the diagonal block's columns as the factor meets them
  __shared__ T ljj[W][W + 1];   // its factor
  __shared__ T linv[W][W + 1];  // its inverse
  __shared__ T rdiag[W];        // 1 / its diagonal
  __shared__ int failed;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kK1Threads / 32;
  const int gwarp = rank * nwarps + warp;  // the warp's index in the cluster
  constexpr int cwarps = kK1Cluster * nwarps;
#ifdef SKERES_K1_CLOCKS
  long long mark = clock64();
#endif

  // working copies: L the lower triangle of A with zeros above; X = I; Q's
  // tail zero for good
  for (int i = gwarp; i < n; i += cwarps) {
    const long row = static_cast<long>(i) * n;
    for (int k = lane; k < n; k += 32) {
      l[row + k] = k <= i ? a[row + k] : T(0);
      x[row + k] = i == k ? T(1) : T(0);
    }
  }
  for (int idx = tid; idx < kTile * QS; idx += kK1Threads) q[n * QS + idx] = T(0);
  if (tid == 0) failed = 0;
  cluster.sync();
  K1_MARK(0);

  for (int j = 0; j < n; j += W) {
    const int wp = min(W, n - j);  // columns in this step; the rest pad as I
    // -- diagonal: every CTA's warp 0 factors and inverts the W x W block
    // (the same input, so the same result everywhere; no exchange)
    if (warp == 0) {
      T row[W];  // lane r: row r of the block
#pragma unroll
      for (int s = 0; s < W; ++s)
        row[s] = lane < wp && s < wp && s <= lane ? l[static_cast<long>(j + lane) * n + j + s]
                                                 : T(s == lane ? 1 : 0);
      bool ok = true;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (lane < W) col[c][lane] = row[c];  // column c as the earlier steps left it
        __syncwarp();
        const T d = col[c][c];  // the same pivot in every lane
        ok = ok && d > T(0) && !isinf(d);
        const T piv = sqrt(d);
        const T rs = T(1) / piv;
        if (lane == c) row[c] = piv;
        else if (lane > c) row[c] *= rs;
#pragma unroll
        for (int k = c + 1; k < W; ++k)
          if (lane >= k) row[k] -= row[c] * (col[c][k] * rs);
        if (lane == 0) rdiag[c] = rs;
      }
      if (lane < W)
#pragma unroll
        for (int s = 0; s < W; ++s) ljj[lane][s] = row[s];
      __syncwarp();
      T inv[W];  // lane c: column c of the block's inverse, by substitution
#pragma unroll
      for (int r = 0; r < W; ++r) {
        T even = r == lane ? T(1) : T(0), odd = T(0);  // two chains, half as long
#pragma unroll
        for (int s = 0; s < r; ++s) (s % 2 ? odd : even) -= ljj[r][s] * inv[s];
        inv[r] = (even + odd) * rdiag[r];
      }
      if (lane < wp) {
        T* qrow = q + (j + lane) * QS;  // Q[j + c] = X[J, j + c]^T
#pragma unroll
        for (int t = 0; t < W; ++t) qrow[t] = inv[t];
      }
      if (lane < W)  // float64: lanes W..31 hold no column
#pragma unroll
        for (int t = 0; t < W; ++t) linv[t][lane] = inv[t];
      if (lane == 0 && !ok) failed = 1;
    }
    __syncthreads();
    K1_MARK(1);
    if (failed) break;  // the same value in every thread of the cluster

    // -- multiply: v <- Ljj^-1 v for X's columns c < j and L's rows c >= j + W;
    // CTA `rank` takes one chunk of them, kSplit threads a column, thread
    // part p the outputs t = p, p + kSplit, ... (equal work). One pass, no
    // loop: a loop would let the compiler hoist linv's values out of it and
    // spill them
    const int rest = n - wp;  // columns outside the diagonal block
    const int chunk = (rest + kK1Cluster - 1) / kK1Cluster;
    static_assert((kMaxN + kK1Cluster - 1) / kK1Cluster * kSplit <= kK1Threads,
                  "one pass covers a chunk");
    const int idx = rank * chunk + tid / kSplit, part = tid % kSplit;
    const bool active = idx < min(rest, (rank + 1) * chunk);
    const int c = idx < j ? idx : idx + wp;
    const bool is_x = c < j;
    T v[W];
#pragma unroll
    for (int s = 0; s < W; ++s)
      v[s] = !active || s >= wp ? T(0)
             : is_x             ? x[static_cast<long>(j + s) * n + c]
                                : l[static_cast<long>(c) * n + j + s];
    __syncwarp();  // a column's kSplit threads, one warp, have read v before any overwrites it
    if (active) {
      T* qrow = q + c * QS;
#pragma unroll
      for (int k = 0; k < W / kSplit; ++k) {
        const int t = part + kSplit * k;
        T acc = T(0);
#pragma unroll
        for (int s = 0; s < W; ++s)
          if (s <= kSplit * k + kSplit - 1) acc += s <= t ? linv[t][s] * v[s] : T(0);
        qrow[t] = acc;
        if (t < wp) {
          if (is_x) x[static_cast<long>(j + t) * n + c] = acc;
          else l[static_cast<long>(c) * n + j + t] = acc;
        }
      }
    }
    K1_MARK(2);
    cluster.sync();  // every chunk of Q done; every CTA past its diagonal reads
    // the other CTAs' chunks of Q, 16 bytes a copy through distributed
    // shared memory; CTA 0 stores the diagonal block of L and of X
    for (int idx = tid; idx < rest * (W / kVec); idx += kK1Threads) {
      const int r = idx / (W / kVec), part = idx % (W / kVec);
      const int owner = r / chunk;
      if (owner == rank) continue;
      const int c = r < j ? r : r + wp;
      const T* remote = cluster.map_shared_rank(q, owner);
      reinterpret_cast<uint4*>(q + c * QS)[part] =
          reinterpret_cast<const uint4*>(remote + c * QS)[part];
    }
    if (rank == 0)
      for (int idx = tid; idx < wp * wp; idx += kK1Threads) {
        const int r = idx / wp, s = idx % wp;
        const long at = static_cast<long>(j + r) * n + j + s;
        l[at] = s <= r ? ljj[r][s] : T(0);
        x[at] = linv[r][s];
      }
    __syncthreads();
    K1_MARK(3);

    // -- update: rows i >= j + W, M[i][c] -= Q[i] . Q[c] for c <= i, on
    // 32 x 32 tiles dealt to the cluster's warps; M is X left of column
    // j + W and L from there on
    const int r0 = j + W;
    if (r0 < n) {
      const int nbr = (n - r0 + kTile - 1) / kTile;
      const int last_cb = (n - 1) / kTile;
      int bi = 0, base = 0;
      auto count = [&](int b) { return min((r0 + kTile * b + kTile - 1) / kTile, last_cb) + 1; };
      for (int tile = gwarp;; tile += cwarps) {
        while (bi < nbr && tile >= base + count(bi)) base += count(bi++);
        if (bi >= nbr) break;
        const int ri = r0 + kTile * bi;
        const int ci = kTile * (tile - base);
        T acc[MT][NT][Tc<T>::kAcc];
        zero<T, MT, NT>(acc);
        warp_mma<MT, NT, W>(q + ri * QS, q + ci * QS, QS, acc, lane);
        // read-modify-write SL m-slices at a time, their loads all in flight
        // together: the whole tile in float32 (32 values), half of it in
        // float64, whose accumulators take twice the registers
        const int g = lane >> 2, tq = lane & 3;
        constexpr int SL = sizeof(T) == 4 ? MT : MT / 2;
#pragma unroll
        for (int m0 = 0; m0 < MT; m0 += SL) {
          T cur[SL][NT][Tc<T>::kAcc];
#pragma unroll
          for (int mt = 0; mt < SL; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < Tc<T>::kAcc; ++e) {
                const int i = ri + (m0 + mt) * Tc<T>::kRows + g + 8 * (e >> 1);
                const int c = ci + nt * 8 + 2 * tq + (e & 1);
                cur[mt][nt][e] =
                    i < n && c <= i ? (c < r0 ? x : l)[static_cast<long>(i) * n + c] : T(0);
              }
#pragma unroll
          for (int mt = 0; mt < SL; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < Tc<T>::kAcc; ++e) {
                const int i = ri + (m0 + mt) * Tc<T>::kRows + g + 8 * (e >> 1);
                const int c = ci + nt * 8 + 2 * tq + (e & 1);
                if (i < n && c <= i)
                  (c < r0 ? x : l)[static_cast<long>(i) * n + c] =
                      cur[mt][nt][e] - acc[m0 + mt][nt][e];
              }
        }
      }
    }
    K1_MARK(4);
    cluster.sync();
    K1_MARK(5);
  }

  if (failed) {
    const T nan = T(NAN);
    for (int i = gwarp; i < n; i += cwarps) {
      const long row = static_cast<long>(i) * n;
      for (int k = lane; k < n; k += 32) {
        l[row + k] = nan;
        x[row + k] = nan;
      }
    }
    K1_MARK(6);
  }
}

template <typename T>
int launch_k1(const void* a, void* l, void* linv, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(chol_inv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(k1_smem_bytes<T>(kMaxN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_kernel<T><<<kK1Cluster, kK1Threads, k1_smem_bytes<T>(n),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(l), static_cast<T*>(linv), n);
  return static_cast<int>(cudaGetLastError());
}

// --- the trailing update -------------------------------------------------------------

constexpr int kUpTile = 128;  // C tile, 128 x 128
constexpr int kUpStages = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Triangular tile index of a block: (bi, bk) with bk <= bi.
__device__ __forceinline__ void lower_tile(int tile, int& bi, int& bk) {
  bi = static_cast<int>((sqrt(8.0 * tile + 1.0) - 1.0) * 0.5);
  while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
  while (bi * (bi + 1) / 2 > tile) --bi;
  bk = tile - bi * (bi + 1) / 2;
}

// float32 on wgmma. A = rows i of the tile, B = rows k, each 128 rows x 32
// values (128 bytes) a stage, land raw through cp.async (P itself stays
// L2-resident) in the 128-byte swizzled K-major layout (16-byte chunk c of
// row r at chunk c ^ (r % 8)). A goes to the tensor cores from registers:
// each warp reads its fragments and splits them there, hi = tf32(x)
// rounded and lo = x - hi. B comes from shared memory through descriptors:
// the block splits its tile in place (hi) with lo in a tile beside it.
// Shared memory bandwidth is what the three passes spend most, and this
// keeps A's hi and lo out of it. Two warpgroups, each 64 rows x 128
// columns of C: per k8 step three m64n128k8 TF32 wgmma, lo.hi + hi.lo +
// hi.hi into one f32 accumulator.
constexpr int kWgThreads = 256;
constexpr int kWgTileBytes = kUpTile * 128;  // one operand tile of a stage
constexpr size_t kWgSmem = size_t(kUpStages) * 3 * kWgTileBytes + 1024;  // + alignment slack

// K-major, 128-byte swizzle: start address, leading offset unused (1),
// stride 1024 bytes between 8-row groups, layout type 1
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// A from registers: a[0..3] = (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// of the warp's 16 rows, as mma.m16n8k8's A fragment
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__global__ void __launch_bounds__(kWgThreads, 1)
syrk_lower_tf32x3_kernel(const float* __restrict__ p, long ldp, int m, int w,
                         float* __restrict__ c, long ldc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of address bits: tiles start at 1024 bytes
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  int bi, bk;
  lower_tile(blockIdx.x, bi, bk);
  const int i0 = bi * kUpTile, k0 = bk * kUpTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  // stage s, operand q (0 A; 1 B, hi after the split; 2 B lo)
  auto tile = [&](int s, int q) { return smem + (s * 3 + q) * kWgTileBytes; };

  auto load = [&](int stage, int kt) {
    const int kb = kt * 32;
    for (int idx = tid; idx < 2 * kUpTile * 8; idx += kWgThreads) {
      const int q = idx / (kUpTile * 8), r = (idx / 8) % kUpTile, ch = idx % 8;
      const int row = (q == 0 ? i0 : k0) + r;
      const bool valid = row < m && kb + ch * 4 < w;
      cp_async16(tile(stage, q) + r * 128 + ((ch ^ (r & 7)) << 4),
                 valid ? p + row * ldp + kb + ch * 4 : p, valid);
    }
  };
  // B: hi in place of x, lo beside it; a position maps to the same
  // position, so the swizzle carries over
  auto split = [&](int stage) {
    for (int off = tid * 16; off < kWgTileBytes; off += kWgThreads * 16) {
      uint4* xs = reinterpret_cast<uint4*>(tile(stage, 1) + off);
      uint4* los = reinterpret_cast<uint4*>(tile(stage, 2) + off);
      uint4 v = *xs, lo;
      split_tf32(__uint_as_float(v.x), v.x, lo.x);
      split_tf32(__uint_as_float(v.y), v.y, lo.y);
      split_tf32(__uint_as_float(v.z), v.z, lo.z);
      split_tf32(__uint_as_float(v.w), v.w, lo.w);
      *xs = v;
      *los = lo;
    }
  };

  // this thread's 64 values of C, read now so that the reads overlap the
  // main loop: accumulator 4j + e is row 16 (warp % 4) + lane / 4 + 8 (e / 2)
  // and column 8j + 2 (lane % 4) + e % 2 of the warpgroup's 64 x 128; pairs
  // (k, k + 1) in one 8-byte access where C's rows allow it
  const bool paired = ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % sizeof(float2) == 0;
  const int g = lane >> 2, tq = lane & 3;
  float cur[64];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
      const int k = k0 + 8 * j + 2 * tq;
      const float* at = c + i * ldc + k;
      float2 v = make_float2(0.f, 0.f);
      if (i < m && k + 1 <= i && paired) v = *reinterpret_cast<const float2*>(at);
      else if (i < m && k <= i) v = make_float2(at[0], k + 1 <= i ? at[1] : 0.f);
      cur[4 * j + 2 * h] = v.x;
      cur[4 * j + 2 * h + 1] = v.y;
    }

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const int nk = (w + 31) / 32;
  // the pipeline: while the wgmma of stage kt run, the block splits stage
  // kt + 1 and issues the loads of stage kt + 2 (into the stage that the
  // wgmma of kt - 1 read)
#pragma unroll
  for (int s = 0; s < kUpStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kUpStages - 2>();
  __syncthreads();
  split(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  __syncthreads();
  // the warp's A rows: r0 + g and r0 + g + 8; element (r, k) of a swizzled
  // tile at byte r * 128 + ((k / 4) ^ (r % 8)) * 16 + (k % 4) * 4
  const int r0 = wg * 64 + (warp & 3) * 16;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kUpStages;
    const unsigned char* at = tile(st, 0);
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e & 1), chunk = 2 * kk + (e >> 1);
        const float x = *reinterpret_cast<const float*>(at + r * 128 +
                                                        ((chunk ^ (r & 7)) << 4) + tq * 4);
        split_tf32(x, ahi[kk][e], alo[kk][e]);
      }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k8 steps: 32 bytes along the swizzled row
      const uint64_t bhi = wgmma_desc(tile(st, 1) + kk * 32), blo = wgmma_desc(tile(st, 2) + kk * 32);
      wgmma_tf32(acc, alo[kk], bhi);
      wgmma_tf32(acc, ahi[kk], blo);
      wgmma_tf32(acc, ahi[kk], bhi);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt + kUpStages - 1 < nk) load((kt + kUpStages - 1) % kUpStages, kt + kUpStages - 1);
    cp_async_commit();
    if (kt + 1 < nk) {
      cp_async_wait<kUpStages - 2>();
      __syncthreads();  // stage kt + 1 landed for all
      split((kt + 1) % kUpStages);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();  // stage kt + 1 split for all; stage kt read
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
      const int k = k0 + 8 * j + 2 * tq;
      if (i >= m || k > i) continue;
      float* at = c + i * ldc + k;
      const float d0 = cur[4 * j + 2 * h] - acc[4 * j + 2 * h];
      const float d1 = cur[4 * j + 2 * h + 1] - acc[4 * j + 2 * h + 1];
      if (paired && k + 1 <= i) {
        *reinterpret_cast<float2*>(at) = make_float2(d0, d1);
      } else {
        at[0] = d0;
        if (k + 1 <= i) at[1] = d1;
      }
    }
}

// float64 on DMMA (mma.sync m8n8k4): 8 warps of 64 x 32 over the tile, the
// P tiles (128 rows x 16 values) through the same three-stage cp.async ring,
// rows padded to 160 bytes against bank conflicts.
constexpr int kF64Threads = 256;
constexpr int kF64Depth = 16, kF64Ld = kF64Depth + 4;
constexpr size_t kF64Smem = size_t(2) * kUpStages * kUpTile * kF64Ld * sizeof(double);

__global__ void __launch_bounds__(kF64Threads, 1)
syrk_lower_f64_kernel(const double* __restrict__ p, long ldp, int m, int w,
                      double* __restrict__ c, long ldc) {
  constexpr int MT = 8, NT = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sa = reinterpret_cast<double*>(smem);  // kUpStages x kUpTile x kF64Ld: rows of C's tile
  double* sb = sa + kUpStages * kUpTile * kF64Ld;  // the same for its columns
  int bi, bk;
  lower_tile(blockIdx.x, bi, bk);
  const int i0 = bi * kUpTile, k0 = bk * kUpTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;
  // a warp tile of a diagonal tile that lies wholly above the diagonal
  const bool idle = bi == bk && wc > wr + 63;

  auto load = [&](int stage, int kt) {
    double* da = sa + stage * kUpTile * kF64Ld;
    double* db = sb + stage * kUpTile * kF64Ld;
    const int kb = kt * kF64Depth;
    for (int idx = tid; idx < kUpTile * 8; idx += kF64Threads) {
      const int r = idx / 8, col = (idx % 8) * 2;
      const bool kin = kb + col < w;
      const bool va = kin && i0 + r < m, vb = kin && k0 + r < m;
      cp_async16(da + r * kF64Ld + col, va ? p + (i0 + r) * ldp + kb + col : p, va);
      cp_async16(db + r * kF64Ld + col, vb ? p + (k0 + r) * ldp + kb + col : p, vb);
    }
  };

  double acc[MT][NT][2];
  zero<double, MT, NT>(acc);
  const int nk = (w + kF64Depth - 1) / kF64Depth;
#pragma unroll
  for (int s = 0; s < kUpStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kUpStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is free again
    if (kt + kUpStages - 1 < nk) load((kt + kUpStages - 1) % kUpStages, kt + kUpStages - 1);
    cp_async_commit();
    const int st = kt % kUpStages;
    if (!idle)
      warp_mma<MT, NT, kF64Depth>(sa + (st * kUpTile + wr) * kF64Ld,
                                  sb + (st * kUpTile + wc) * kF64Ld, kF64Ld, acc, lane);
  }
  cp_async_wait<0>();
  if (idle) return;

  const bool paired = ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % sizeof(double2) == 0;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int i = i0 + wr + mt * 8 + g;
      const int k = k0 + wc + nt * 8 + 2 * tq;
      if (i >= m || k > i) continue;
      double* at = c + i * ldc + k;
      if (paired && k + 1 <= i) {
        double2 v = *reinterpret_cast<double2*>(at);
        v.x -= acc[mt][nt][0];
        v.y -= acc[mt][nt][1];
        *reinterpret_cast<double2*>(at) = v;
      } else {
        at[0] -= acc[mt][nt][0];
        if (k + 1 <= i) at[1] -= acc[mt][nt][1];
      }
    }
}

inline unsigned lower_tiles(int m) {
  const long nb = (m + kUpTile - 1) / kUpTile;
  return static_cast<unsigned>(nb * (nb + 1) / 2);
}

}  // namespace

extern "C" int skeres_chol_inv_f32(const void* a, void* l, void* linv, int n, void* stream) {
  return launch_k1<float>(a, l, linv, n, stream);
}

extern "C" int skeres_chol_inv_f64(const void* a, void* l, void* linv, int n, void* stream) {
  return launch_k1<double>(a, l, linv, n, stream);
}

// C (m x m, row stride ldc) -= P P^T on and below the diagonal, P m x w
// with row stride ldp. Needs w and ldp multiples of 4 and 16-byte aligned
// rows (the wrapper pads P otherwise).
extern "C" int skeres_syrk_lower_f32(const void* p, long ldp, int m, int w, void* c, long ldc,
                                     void* stream) {
  if (m < 1 || w < 1 || w % 4 != 0 || ldp % 4 != 0 || ldc < m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(syrk_lower_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWgSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  syrk_lower_tf32x3_kernel<<<lower_tiles(m), kWgThreads, kWgSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), ldp, m, w, static_cast<float*>(c), ldc);
  return static_cast<int>(cudaGetLastError());
}

// The same in float64. Needs w and ldp even and 16-byte aligned rows.
extern "C" int skeres_syrk_lower_f64(const void* p, long ldp, int m, int w, void* c, long ldc,
                                     void* stream) {
  if (m < 1 || w < 1 || w % 2 != 0 || ldp % 2 != 0 || ldc < m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(syrk_lower_f64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kF64Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  syrk_lower_f64_kernel<<<lower_tiles(m), kF64Threads, kF64Smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(p), ldp, m, w, static_cast<double*>(c), ldc);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SKERES_K1_CLOCKS
// copy K1's seven phase sums (cycles of thread 0) to out and clear them
extern "C" int skeres_k1_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k1_clocks, sizeof(k1_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[7] = {0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(k1_clocks, zeros, sizeof(zeros)));
}
#endif
