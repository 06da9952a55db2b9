// Blocked lower Cholesky factor for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel conicip_tpu/ops/pallas_cholesky.py:_kernel
// (launched by _cholesky_pallas through pl.pallas_call). Like that kernel it
// returns the lower factor L of an SPD matrix with the strict upper triangle
// zeroed. Unlike it, it takes any n >= 1: the 128-alignment, the 1280 cap
// and the identity padding of the TPU version were artifacts of VMEM.
//
// What bounds it. At n = 1024 in double the factor is n^3/3 = 0.36 GFLOP
// over an 8 MB matrix: about 10 us of the card's FP64 rate and under 3 us
// of its memory bandwidth. The time is set instead by the serial chain of
// n/NB panels, each a dependent sequence of small launches, and by the
// latency of the column sweep inside each diagonal tile.
//
// What the design does about it. A host loop walks NB-wide panels; each
// panel issues three kernels on the caller's stream and never synchronises:
//   1. factor_diag:     one warp factors the NB x NB diagonal tile in
//                       registers by a column sweep on warp shuffles;
//   2. panel_solve:     one thread per row below the tile solves
//                       x L_kk^T = a_row in registers, all rows in parallel;
//   3. trailing_update: a 2-D grid of TS x TS lower tiles applies
//                       A22 -= L21 L21^T (SYRK-like, 4x4 per thread).
// The working set of each tile stays in shared memory, the matrix itself in
// L2 (8 MB of 50 MB at n = 1024). Folding the triangular inverse and the
// ridge retry into the kernel, and a batched form, are later work.
//
// Failure semantics. The ridge retry of the Schur KKT solver retries while
// L is not all finite. A non-positive (or NaN) pivot therefore writes NaN,
// as sqrt does in the TPU kernel, and the NaN spreads through the column
// below and the trailing matrix; the kernel never writes a finite value in
// its place. No cuBLAS or cuSOLVER call is made.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NB = 32;   // panel width
constexpr int PR = 128;  // rows (threads) per block in the panel solve
constexpr int TS = 64;   // trailing-update tile
constexpr int TT = 16;   // threads per tile side; each thread owns TS/TT^2
constexpr int RT = TS / TT;

template <typename T> __device__ __forceinline__ T pivot_root(T a);
template <> __device__ __forceinline__ double pivot_root(double a) {
  return a > 0.0 ? sqrt(a) : CUDART_NAN;
}
template <> __device__ __forceinline__ float pivot_root(float a) {
  return a > 0.0f ? sqrtf(a) : CUDART_NAN_F;
}

// out = tril(in)
template <typename T>
__global__ void copy_lower(const T* __restrict__ in, T* __restrict__ out,
                           int n) {
  const size_t total = (size_t)n * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / n, c = i % n;
    out[i] = c <= r ? in[i] : T(0);
  }
}

// Factor the kb x kb diagonal tile at (k, k) in place with one warp: lane r
// holds row r of the tile in registers and the column sweep runs on warp
// shuffles, with no barrier. Rows and columns past kb are padded with the
// identity, whose factor is the identity, and are not written back.
template <typename T>
__global__ void factor_diag(T* __restrict__ a, int n, int k, int kb) {
  const int r = threadIdx.x;
  T x[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c)
    x[c] = (r < kb && c < kb) ? (c <= r ? a[(size_t)(k + r) * n + k + c] : T(0))
                              : T(c == r);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const T ljj = pivot_root(__shfl_sync(0xffffffffu, x[j], j));
    x[j] = r == j ? ljj : (r > j ? x[j] / ljj : x[j]);
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const T lcj = __shfl_sync(0xffffffffu, x[j], c);
      if (r >= c) x[c] -= x[j] * lcj;
    }
  }
  if (r < kb) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c <= r) a[(size_t)(k + r) * n + k + c] = x[c];
  }
}

// Rows k+NB .. n-1 of the panel columns k .. k+NB-1: X <- X L_kk^-T.
// One thread per row, PR rows per block: the tile is staged through shared
// memory for coalesced loads and stores, and each thread then runs its
// row's forward substitution in registers against L_kk in shared memory.
template <typename T>
__global__ void panel_solve(T* __restrict__ a, int n, int k, int rest) {
  __shared__ T sl[NB][NB + 1];
  __shared__ T sx[PR][NB + 1];
  const int t = threadIdx.x;
  const int row0 = k + NB + blockIdx.x * PR;
  for (int e = t; e < NB * NB; e += PR) {
    const int r = e / NB, c = e % NB;
    sl[r][c] = c <= r ? a[(size_t)(k + r) * n + k + c] : T(0);
  }
  for (int e = t; e < PR * NB; e += PR) {
    const int r = e / NB, c = e % NB;
    sx[r][c] = row0 + r < n ? a[(size_t)(row0 + r) * n + k + c] : T(0);
  }
  __syncthreads();
  T x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    T acc = sx[t][j];
#pragma unroll
    for (int l = 0; l < j; ++l) acc -= x[l] * sl[j][l];
    x[j] = acc / sl[j][j];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) sx[t][j] = x[j];
  __syncthreads();
  for (int e = t; e < PR * NB; e += PR) {
    const int r = e / NB, c = e % NB;
    if (row0 + r < n) a[(size_t)(row0 + r) * n + k + c] = sx[r][c];
  }
}

// A22 -= L21 L21^T on the lower tiles of the trailing matrix, which starts
// at row/col k+NB and has `rest` rows. Grid (tiles, tiles), block (TT, TT).
template <typename T>
__global__ void trailing_update(T* __restrict__ a, int n, int k, int rest) {
  const int bj = blockIdx.x, bi = blockIdx.y;
  if (bj > bi) return;  // strict upper tiles are never read
  __shared__ T si[TS][NB + 1];
  __shared__ T sj[TS][NB + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TT + tx;
  const int off = k + NB;
  for (int e = tid; e < TS * NB; e += TT * TT) {
    const int r = e / NB, l = e % NB;
    const int ri = bi * TS + r, rj = bj * TS + r;
    si[r][l] = ri < rest ? a[(size_t)(off + ri) * n + k + l] : T(0);
    sj[r][l] = rj < rest ? a[(size_t)(off + rj) * n + k + l] : T(0);
  }
  __syncthreads();
  T acc[RT][RT];
#pragma unroll
  for (int p = 0; p < RT; ++p)
#pragma unroll
    for (int q = 0; q < RT; ++q) acc[p][q] = T(0);
#pragma unroll 8
  for (int l = 0; l < NB; ++l) {
    T x[RT], y[RT];
#pragma unroll
    for (int p = 0; p < RT; ++p) x[p] = si[ty + TT * p][l];
#pragma unroll
    for (int q = 0; q < RT; ++q) y[q] = sj[tx + TT * q][l];
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) acc[p][q] += x[p] * y[q];
  }
#pragma unroll
  for (int p = 0; p < RT; ++p) {
    const int r = bi * TS + ty + TT * p;
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int c = bj * TS + tx + TT * q;
      if (r < rest && c <= r) a[(size_t)(off + r) * n + off + c] -= acc[p][q];
    }
  }
}

template <typename T>
cudaError_t cholesky(const T* in, T* out, int n, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const size_t total = (size_t)n * n;
  const int copy_blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  copy_lower<T><<<copy_blocks, 256, 0, stream>>>(in, out, n);
  cudaError_t err = cudaGetLastError();
  for (int k = 0; k < n && err == cudaSuccess; k += NB) {
    const int kb = n - k < NB ? n - k : NB;
    factor_diag<T><<<1, NB, 0, stream>>>(out, n, k, kb);
    const int rest = n - k - kb;  // > 0 only when kb == NB
    if (rest > 0) {
      panel_solve<T><<<(rest + PR - 1) / PR, PR, 0, stream>>>(
          out, n, k, rest);
      const int tiles = (rest + TS - 1) / TS;
      trailing_update<T><<<dim3(tiles, tiles), dim3(TT, TT), 0, stream>>>(
          out, n, k, rest);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Plain C entry points, bound with ctypes. `in` and `out` are distinct
// row-major contiguous n x n device buffers; nothing is allocated and the
// stream is not synchronised. Returns cudaGetLastError() after the launches.
extern "C" int conicip_cholesky_f64(const void* in, void* out, int n,
                                    void* stream) {
  return (int)cholesky<double>(static_cast<const double*>(in),
                               static_cast<double*>(out), n,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_cholesky_f32(const void* in, void* out, int n,
                                    void* stream) {
  return (int)cholesky<float>(static_cast<const float*>(in),
                              static_cast<float*>(out), n,
                              static_cast<cudaStream_t>(stream));
}
