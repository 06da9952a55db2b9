// Blocked lower Cholesky factor for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel conicip_tpu/ops/pallas_cholesky.py:_kernel
// (launched by _cholesky_pallas through pl.pallas_call). Like that kernel it
// returns the lower factor L of an SPD matrix with the strict upper triangle
// zeroed. Unlike it, it takes any n >= 1: the 128-alignment, the 1280 cap
// and the identity padding of the TPU version were artifacts of VMEM.
//
// What bounds it on an H100. A factor is n^3/3 multiply-adds: 22.9 GFLOP at
// n = 4096, 0.35 ms at the FP64 tensor-core rate (~67 TFLOP/s on the data
// sheet; mma.sync.m16n8k4.f64 reached 65.6 TFLOP/s on an H100 80GB HBM3,
// m8n8k4 half that). A right-looking factor with NB-wide panels streams the
// lower trailing matrix through device memory once per panel: about
// sum(rest^2 / 2) * 8 B * 3, 8.6 GB with NB = 32 (2.6 ms at 3.35 TB/s) and
// 2.2 GB with NB = 128 (0.65 ms). Under those bounds, and at any n <= 2048,
// where the matrix sits in the 50 MB L2, the time is the serial chain: n
// pivots, each a square root that the threads using it must see. On that
// card one barrier-separated step (barrier, shared-memory round trip, f64
// rsqrt) took ~700 cycles, so one column per step would cost ~0.36 ms at
// n = 1024 on its own. PERF.md has the measured times.
//
// What the design does about it.
//   - 128-wide panels, three kernels each on the caller's stream, never
//     synchronising. n <= 128 is one launch of factor_diag alone; a larger
//     factor is at most 3 ceil(n / 128) - 1 launches: the copy of the lower
//     triangle, the first diagonal block, then three per panel.
//   - factor_diag: one block factors the 128 x 128 diagonal block in shared
//     memory as four 32 x 32 leaves. A leaf is factored and inverted
//     together in registers, four columns per barrier (every thread factors
//     the group's 4 x 4 diagonal block for itself), 8 barriers a leaf and
//     not 32. The rows below a leaf are a product with the leaf's inverse,
//     and the rest of the block is updated, on warp-level mma tiles; then
//     inv(L_kk) is built from the leaf inverses by recursion on halves and
//     written to the scratch buffer `work`.
//   - panel_product: X <- X inv(L_kk)^T for the rows below the block, a
//     product instead of a row-by-row substitution.
//   - trailing_update: A22 -= X X^T on the lower 64 x 64 tiles only, a
//     persistent grid of one block per SM on all SMs but one. Its first
//     tiles make up the next diagonal block. The next factor_diag is
//     launched beside it (programmatic dependent launch) on the free SM,
//     waits on a counter for those tiles only, and for the whole grid
//     before it ends: the chain of diagonal blocks overlaps the updates.
//   - a stack of matrices (the batched solve's per-iteration factors) is the
//     second dimension of every grid: matrix blockIdx.y of a contiguous
//     (B, n, n) buffer, with its own inverse block and counter in `work`.
//     The launches are those of one matrix whatever B is, and each matrix
//     gets the arithmetic of the single entry, which is the batch of one.
//   - a predicated factor: with a device flag per matrix, a flagged matrix's
//     kernels return at their first instruction and leave `out` as it was,
//     so the Schur solver's ridge retries are decided on the device and a
//     retry not needed costs the launches' latency, not a factor.
//   The products stage 32-deep chunks of both operands in shared memory with
//   cp.async (16 bytes a copy where rows are aligned), the tile of A22
//   preloaded into the sums. In double they run on the FP64 tensor cores
//   (mma.sync.m16n8k4.f64); in float on FFMA, since the tensor cores take
//   float only as TF32, which the reference's full-precision products rule
//   out.
//
// Shared memory of factor_diag in double: the block (128 x 132) is 132 KB,
// so L_kk and a second 128 x 128 buffer for its inverse (128 KB) do not fit
// in the 227 KB a block may use. The block is therefore written back as
// L_kk first and inverted in place: the four leaf inverses sit in a 36 KB
// side buffer, the off-diagonal blocks of the inverse overwrite those of
// L_kk through a 34 KB buffer of partial products, and the result is copied
// to `work`. In all 206 KB.
//
// Failure semantics. The ridge retry of the Schur KKT solver retries while
// L is not all finite. A non-positive (or NaN) pivot is replaced by NaN, as
// sqrt does in the TPU kernel, and every entry on and below the diagonal
// from that column on becomes NaN: in the leaf and the rest of the diagonal
// block, in every row of inv(L_kk) from that column on and through it in
// every row below the block, and through the trailing updates in the whole
// remaining matrix; the columns before it stay finite. No finite value is
// written in its place. No cuBLAS or cuSOLVER call is made.
//
// The same source holds the explicit inverse of a lower factor (tri_inverse,
// below the factor's kernels), whose diagonal blocks are inverted as
// factor_diag inverts its block.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NB = 128;             // outer panel width
constexpr int LEAF = 32;            // inner strip width
// Row strides in shared memory, 8 banks apart from row to row (in double),
// so that the fragments of mma.sync come without bank conflicts.
constexpr int LD = NB + 4;          // the diagonal block
constexpr int VL = LEAF + 4;        // the leaf inverses
constexpr int PL = 64 + 4;          // the partial products of the inverse
constexpr int GROUP = 4;            // leaf columns per barrier
constexpr int CL = GROUP * LEAF;    // a group's published columns
static_assert(96 * VL <= 64 * PL, "the leaf's panel fits the product buffer");
constexpr int DIAG_THREADS = 512;
constexpr int KC = 32;              // depth of one staged operand chunk
constexpr int GEMM_THREADS = 256;
constexpr int PANEL_ROWS = 32;      // rows of the panel product per block
constexpr int PANEL_STAGES = 4;     // chunks in flight in the panel product
constexpr int TS = 64;              // trailing-update tile
constexpr int TRAIL_STAGES = 2;     // chunks in flight in the trailing update
// Scratch of one matrix in `work`: the inverse of a diagonal block, then the
// counter of finished tiles, padded so that every matrix's inverse starts on
// a 16-byte boundary (cp.async copies 16 bytes from it).
constexpr int WORK_STRIDE = NB * NB + 4;

// Row stride of a staged chunk: rows stay 16-byte aligned for cp.async, and
// 8 banks apart in double for the mma fragments.
constexpr int CHUNK_LD = KC + 4;

template <typename T>
constexpr size_t diag_smem() {
  return (size_t)(NB * LD + 4 * LEAF * VL + 64 * PL + 4 * CL) * sizeof(T);
}

template <typename T>
constexpr size_t gemm_smem(int bm, int bn, int stages) {
  return (size_t)stages * (bm + bn) * CHUNK_LD * sizeof(T);
}

// A positive pivot, or NaN.
__device__ __forceinline__ double pivot(double d) {
  return d > 0.0 ? d : CUDART_NAN;
}
__device__ __forceinline__ float pivot(float d) {
  return d > 0.0f ? d : CUDART_NAN_F;
}
__device__ __forceinline__ double rsq(double d) { return rsqrt(d); }
__device__ __forceinline__ float rsq(float d) { return rsqrtf(d); }

// Every kernel takes the batch as blockIdx.y: matrix blockIdx.y of a
// contiguous (B, n, n) stack, with its own scratch in `work`. A single
// matrix is the batch of one.
template <typename T>
__device__ __forceinline__ T* batch_matrix(T* a, int n) {
  return a + (size_t)blockIdx.y * n * n;
}
template <typename T>
__device__ __forceinline__ T* batch_work(T* work) {
  return work + (size_t)blockIdx.y * WORK_STRIDE;
}
template <typename T>
__device__ __forceinline__ unsigned* ready_counter(T* work_b) {
  return reinterpret_cast<unsigned*>(work_b + NB * NB);
}

// The predicated factor: where matrix blockIdx.y's flag in `skip` is set,
// each kernel of its factor returns at its first instruction and leaves
// `out` as it was. Null runs every matrix. The Schur solver's ridge retries
// take this form, so a retry that is not needed costs empty launches, not a
// factor, and no flag is read back to the host.
__device__ __forceinline__ bool skipped(const unsigned char* skip) {
  return skip != nullptr && skip[blockIdx.y] != 0;
}

// out = tril(in); also clears the counter of finished diagonal tiles.
template <typename T>
__global__ void copy_lower(const T* __restrict__ in, T* __restrict__ out,
                           int n, T* __restrict__ work,
                           const unsigned char* __restrict__ skip) {
  if (skipped(skip)) return;
  in = batch_matrix(in, n);
  out = batch_matrix(out, n);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *ready_counter(batch_work(work)) = 0;
  const size_t total = (size_t)n * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / n, c = i % n;
    out[i] = c <= r ? in[i] : T(0);
  }
}

// Tile (bi, bj), bj <= bi, of a triangular enumeration x = bi (bi+1)/2 + bj.
__device__ __forceinline__ void tri_tile(int x, int& bi, int& bj) {
  bi = (int)((sqrt(8.0 * x + 1.0) - 1.0) * 0.5);
  while ((bi + 1) * (bi + 2) / 2 <= x) ++bi;
  while (bi * (bi + 1) / 2 > x) --bi;
  bj = x - bi * (bi + 1) / 2;
}

// One warp's 16 x 16 tile: acc += A B (NN: B row-major, K x 16) or A B^T
// (NT: B given as 16 rows of K), A being 16 rows of K; all in shared
// memory. acc[j][e] is C(g + 8 (e / 2), 8 j + 2 q + e % 2) for lane
// (g, q) = (lane / 4, lane % 4), the accumulator layout of
// mma.sync.m16n8k4 (two of them per step of 4, one for each 8 columns).
template <bool BT>
__device__ __forceinline__ void warp_mm(double (&acc)[2][4], const double* A,
                                        int lda, const double* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 4) {
    const double a0 = A[g * lda + kk + q], a1 = A[(g + 8) * lda + kk + q];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const double b =
          BT ? B[(8 * j + g) * ldb + kk + q] : B[(kk + q) * ldb + 8 * j + g];
      asm volatile(
          "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
          "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
          : "+d"(acc[j][0]), "+d"(acc[j][1]), "+d"(acc[j][2]), "+d"(acc[j][3])
          : "d"(a0), "d"(a1), "d"(b));
    }
  }
}
template <bool BT>
__device__ __forceinline__ void warp_mm(float (&acc)[2][4], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float a[2] = {A[g * lda + kk], A[(g + 8) * lda + kk]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * q + e % 2;
        acc[j][e] = fmaf(a[e / 2], BT ? B[c * ldb + kk] : B[kk * ldb + c],
                         acc[j][e]);
      }
  }
}

// Store a warp's 16 x 16 tile at C: C = sign * acc, or C -= acc when sub.
template <typename T>
__device__ __forceinline__ void warp_store(const T (&acc)[2][4], T* C, int ldc,
                                           T sign, bool sub) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      T& c = C[(g + 8 * (e / 2)) * ldc + 8 * j + 2 * q + e % 2];
      c = sub ? c - acc[j][e] : sign * acc[j][e];
    }
}

// Wait for the grid this one was launched beside (programmatic dependent
// launch) to finish, so that the next kernel in the stream sees its writes;
// returns at once when there is none.
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The kb x kb diagonal block at (k, k) of src into S (row stride LD), the
// lower triangle only, padded to NB x NB with the identity. Warp w of the
// DIAG_THREADS takes rows w + WARPS q, half of them at a time, all in
// flight.
template <typename T>
__device__ __forceinline__ void load_block(T* S, const T* src, int n, int k,
                                           int kb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int WARPS = DIAG_THREADS / 32, RQ = NB / WARPS, CQ = NB / 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    T v[RQ / 2][CQ];
#pragma unroll
    for (int q = 0; q < RQ / 2; ++q)
#pragma unroll
      for (int cc = 0; cc < CQ; ++cc) {
        const int r = w + WARPS * (q + half * RQ / 2), c = lane + 32 * cc;
        v[q][cc] = r < kb && c <= r
                       ? __ldcg(src + (size_t)(k + r) * n + k + c)
                       : T(r == c);
      }
#pragma unroll
    for (int q = 0; q < RQ / 2; ++q)
#pragma unroll
      for (int cc = 0; cc < CQ; ++cc)
        S[(w + WARPS * (q + half * RQ / 2)) * LD + lane + 32 * cc] = v[q][cc];
  }
}

// inv(L_kk) of the NB x NB block L_kk in S by recursion on halves from the
// inverses of its four leaves in V (LEAF x VL each, strict upper triangle
// zero):
//   inv([A 0; B C]) = [inv(A) 0; -inv(C) (B inv(A)) inv(C)].
// The off-diagonal blocks of the inverse overwrite those of L_kk in S,
// through the partial products in P (64 x PL); its diagonal leaves are V.
template <typename T>
__device__ __forceinline__ void invert_from_leaves(T* S, const T* V, T* P) {
  const int w = threadIdx.x >> 5;
  constexpr int WARPS = DIAG_THREADS / 32;
  {
    // 64 x 64 halves h = 0, 1, with A, B, C their 32 x 32 blocks:
    // P_h = B inv(A), then -inv(C) P_h over B, in 16 x 16 tiles (h, ti, tj).
    for (int x = w; x < 8; x += WARPS) {
      const int h = x / 4, o = 64 * h, ti = (x % 4) / 2, tj = x % 2;
      T acc[2][4] = {};
      warp_mm<false>(acc, S + (o + 32 + 16 * ti) * LD + o, LD,
                     V + (2 * h) * LEAF * VL + 16 * tj, VL, LEAF);
      warp_store(acc, P + 16 * ti * PL + 32 * h + 16 * tj, PL, T(1), false);
    }
    __syncthreads();
    for (int x = w; x < 8; x += WARPS) {
      const int h = x / 4, o = 64 * h, ti = (x % 4) / 2, tj = x % 2;
      T acc[2][4] = {};
      warp_mm<false>(acc, V + (2 * h + 1) * LEAF * VL + 16 * ti * VL, VL,
                     P + 32 * h + 16 * tj, PL, LEAF);
      warp_store(acc, S + (o + 32 + 16 * ti) * LD + o + 16 * tj, LD, T(-1),
                 false);
    }
  }
  __syncthreads();
  {
    // The whole block in 16 x 16 tiles: P = B inv(A) with B = L[64:, :64]
    // and inv(A) = [V0 0; X10 V1], then X[64:, :64] = -inv(C) P with
    // inv(C) = [V2 0; X32 V3].
    for (int x = w; x < 16; x += WARPS) {
      const int ti = x / 4, tj = x % 4;
      const T* Brow = S + (64 + 16 * ti) * LD;
      T acc[2][4] = {};
      if (tj < 2) {
        warp_mm<false>(acc, Brow, LD, V + 16 * tj, VL, LEAF);
        warp_mm<false>(acc, Brow + 32, LD, S + 32 * LD + 16 * tj, LD, LEAF);
      } else {
        warp_mm<false>(acc, Brow + 32, LD, V + LEAF * VL + 16 * (tj - 2), VL,
                       LEAF);
      }
      warp_store(acc, P + 16 * ti * PL + 16 * tj, PL, T(1), false);
    }
    __syncthreads();
    for (int x = w; x < 16; x += WARPS) {
      const int ti = x / 4, tj = x % 4;
      T acc[2][4] = {};
      if (ti < 2) {
        warp_mm<false>(acc, V + 2 * LEAF * VL + 16 * ti * VL, VL, P + 16 * tj,
                       PL, LEAF);
      } else {
        warp_mm<false>(acc, S + (96 + 16 * (ti - 2)) * LD + 64, LD,
                       P + 16 * tj, PL, LEAF);
        warp_mm<false>(acc, V + 3 * LEAF * VL + 16 * (ti - 2) * VL, VL,
                       P + 32 * PL + 16 * tj, PL, LEAF);
      }
      warp_store(acc, S + (64 + 16 * ti) * LD + 16 * tj, LD, T(-1), false);
    }
  }
}

// Factor the kb x kb diagonal block at (k, k) of src into dst (which may be
// src), with the strict upper triangle written as zeros. With `want_inv`
// (then kb == NB), also write inv(L_kk), 128 x 128 row-major, to the
// matrix's scratch in `work`. With `wait`, it runs beside the previous
// panel's trailing update and first waits until that has finished `target`
// tiles of this matrix in all, which include this block's (a bounded wait:
// it traps rather than hang).
// Rows and columns from kb on are padded with the identity, whose factor is
// the identity, and are not written back.
template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS)
factor_diag(const T* src, T* dst, T* work, int n, int k, int kb,
            bool want_inv, bool wait, unsigned target,
            const unsigned char* __restrict__ skip) {
  if (skipped(skip)) return;
  src = batch_matrix(src, n);
  dst = batch_matrix(dst, n);
  T* __restrict__ inv = want_inv ? batch_work(work) : nullptr;
  const unsigned* ready = wait ? ready_counter(batch_work(work)) : nullptr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // the block, L_kk, then inverse
  T* V = S + NB * LD;                     // 4 leaf inverses, LEAF x VL
  T* P = V + 4 * LEAF * VL;               // products: 96 x VL or 64 x PL
  T* col = P + 64 * PL;                   // 2 x CL: a group's columns
  T* yrow = col + 2 * CL;                 // 2 x CL: its rows of the inverse
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  constexpr int WARPS = DIAG_THREADS / 32, RQ = NB / WARPS, CQ = NB / 32;
  constexpr int LR = LEAF / WARPS;  // leaf rows per thread
  const int kr = (kb + LEAF - 1) / LEAF * LEAF;

  if (ready != nullptr) {
    if (t == 0) {
      long long spins = 0;
      while (*(volatile const unsigned*)ready < target) {
        __nanosleep(64);
        if (++spins > (1ll << 26)) __trap();  // seconds: the tiles never came
      }
      __threadfence();
    }
    __syncthreads();
  }
  load_block(S, src, n, k, kb);
  __syncthreads();

  for (int s = 0; s < kr; s += LEAF) {
    // Leaf: L and Y = inv(L) together, right-looking, GROUP columns j ..
    // j+G-1 per barrier, one element of each per (row, column) in
    // registers: warp w owns rows w + WARPS h, lane c column c. A step
    // reads the group's columns of A and rows of Y from shared memory as
    // they were before the step, and every thread factors the group's
    // G x G diagonal block for itself, then its row's and its column's
    // entries of the group:
    //   l_iq = (a_iq - sum_{m<q} l_im l_qm) / l_qq,  l_qq = d / sqrt(d),
    //   x_q = (y_q - sum_{m<q} l_qm x_m) / l_qq,
    //   a_ic -= sum_q l_iq l_cq,  y_i -= sum_q l_iq x_q    (i past the group);
    // the owners of the next group's columns and rows then publish them.
    T* Vs = V + (s / LEAF) * LEAF * VL;
    T a[LR], y[LR];
#pragma unroll
    for (int h = 0; h < LR; ++h) {
      const int i = w + WARPS * h;
      a[h] = S[(s + i) * LD + s + lane];
      y[h] = T(i == lane);
      if (lane < GROUP) col[lane * LEAF + i] = a[h];
      if (i < GROUP) yrow[i * LEAF + lane] = y[h];
    }
    for (int j = 0; j < LEAF; j += GROUP) {
      __syncthreads();
      if (w + WARPS * (LR - 1) < j) continue;  // this warp's rows are done
      const T* cj = col + ((j / GROUP) & 1) * CL;
      const T* yj = yrow + ((j / GROUP) & 1) * CL;
      T* cn = col + ((j / GROUP + 1) & 1) * CL;
      T* yn = yrow + ((j / GROUP + 1) & 1) * CL;
      // the group's diagonal block, its inverse roots, and this lane's
      // column entries l_cq and inverse entries x_qc
      T Lg[GROUP][GROUP], rq[GROUP], lc[GROUP], xq[GROUP];
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        T d = cj[q * LEAF + j + q];
#pragma unroll
        for (int m = 0; m < q; ++m) d -= Lg[q][m] * Lg[q][m];
        d = pivot(d);
        rq[q] = rsq(d);
        Lg[q][q] = d * rq[q];
#pragma unroll
        for (int p = q + 1; p < GROUP; ++p) {
          T v = cj[q * LEAF + j + p];
#pragma unroll
          for (int m = 0; m < q; ++m) v -= Lg[p][m] * Lg[q][m];
          Lg[p][q] = v * rq[q];
        }
        T vc = cj[q * LEAF + lane], vx = yj[q * LEAF + lane];
#pragma unroll
        for (int m = 0; m < q; ++m) {
          vc -= lc[m] * Lg[q][m];
          vx -= Lg[q][m] * xq[m];
        }
        lc[q] = vc * rq[q];
        xq[q] = vx * rq[q];
      }
#pragma unroll
      for (int h = 0; h < LR; ++h) {
        const int i = w + WARPS * h;
        if (i >= j + GROUP) {
          T li[GROUP];
          T na = a[h], ny = y[h];
#pragma unroll
          for (int q = 0; q < GROUP; ++q) {
            T v = cj[q * LEAF + i];
#pragma unroll
            for (int m = 0; m < q; ++m) v -= li[m] * Lg[q][m];
            li[q] = v * rq[q];
            na -= li[q] * lc[q];
            ny -= li[q] * xq[q];
            if (lane == j + q) a[h] = li[q];
          }
          if (lane >= j + GROUP && i >= lane) a[h] = na;
          y[h] = ny;
          if (lane >= j + GROUP && lane < j + 2 * GROUP)
            cn[(lane - j - GROUP) * LEAF + i] = a[h];
          if (i < j + 2 * GROUP) yn[(i - j - GROUP) * LEAF + lane] = y[h];
        } else if (i >= j) {
#pragma unroll
          for (int q = 0; q < GROUP; ++q) {
            if (i == j + q) {
              y[h] = xq[q];
#pragma unroll
              for (int m = 0; m <= q; ++m)
                if (lane == j + m) a[h] = Lg[q][m];
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < LR; ++h) {
      const int i = w + WARPS * h;
      S[(s + i) * LD + s + lane] = a[h];
      Vs[i * VL + lane] = y[h];
    }
    __syncthreads();
    // Rows below the leaf: X = A[e:, s:e] inv(L_ss)^T into P, then the rest
    // of the block, A[e:, e:] -= X X^T, on its lower 16 x 16 tiles, while X
    // is copied back over A[e:, s:e].
    const int e0 = s + LEAF, mt = (kr - e0) / 16;
    for (int x = w; x < mt * 2; x += WARPS) {
      const int ti = x / 2, tj = x % 2;
      T acc[2][4] = {};
      warp_mm<true>(acc, S + (e0 + 16 * ti) * LD + s, LD, Vs + 16 * tj * VL,
                    VL, LEAF);
      warp_store(acc, P + 16 * ti * VL + 16 * tj, VL, T(1), false);
    }
    __syncthreads();
    for (int x = w; x < mt * (mt + 1) / 2; x += WARPS) {
      int ti, tj;
      tri_tile(x, ti, tj);
      T acc[2][4] = {};
      warp_mm<true>(acc, P + 16 * ti * VL, VL, P + 16 * tj * VL, VL, LEAF);
      warp_store(acc, S + (e0 + 16 * ti) * LD + e0 + 16 * tj, LD, T(1), true);
    }
    for (int e = t; e < (kr - e0) * LEAF; e += DIAG_THREADS)
      S[(e0 + e / LEAF) * LD + s + e % LEAF] = P[(e / LEAF) * VL + e % LEAF];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int cc = 0; cc < CQ; ++cc) {
      const int r = w + WARPS * q, c = lane + 32 * cc;
      if (r < kb && c < kb)
        dst[(size_t)(k + r) * n + k + c] = c <= r ? S[r * LD + c] : T(0);
    }
  if (inv == nullptr) {
    wait_prerequisite();
    return;
  }

  // inv(L_kk), kb == NB, from the leaf inverses
  __syncthreads();  // L_kk is written back before it is overwritten
  invert_from_leaves(S, V, P);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int cc = 0; cc < CQ; ++cc) {
      const int r = w + WARPS * q, c = lane + 32 * cc;
      const int br = r / LEAF, bc = c / LEAF;
      inv[r * NB + c] = br == bc ? V[br * LEAF * VL + (r % LEAF) * VL + lane]
                                 : (br > bc ? S[r * LD + c] : T(0));
    }
  wait_prerequisite();
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? (int)sizeof(T) : 0;  // 0: fill with zeros
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}
// cp.async of 16 bytes of which the first `bytes` are read, the rest zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage columns kc .. kc+KC-1 of ROWS rows of g (row stride ld) into s
// (row stride CHUNK_LD); entries in row `rows` or past it, or in column
// `cols` or past it, read as zero. With `vec`, rows of g are 16-byte aligned
// and each copy moves 16 bytes.
template <typename T, int ROWS>
__device__ __forceinline__ void load_chunk(T* s, const T* g, size_t ld,
                                           int rows, int cols, int kc,
                                           bool vec) {
  constexpr int SL = CHUNK_LD, VEC = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * KC / VEC; e += GEMM_THREADS) {
      const int r = e / (KC / VEC), c = e % (KC / VEC) * VEC;
      const int left = r < rows ? cols - kc - c : 0;
      const int count = left < 0 ? 0 : (left < VEC ? left : VEC);
      cp_async16(s + r * SL + c, count > 0 ? g + (size_t)r * ld + kc + c : g,
                 count * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * KC; e += GEMM_THREADS) {
      const int r = e / KC, c = e % KC;
      const bool ok = r < rows && kc + c < cols;
      cp_async(s + r * SL + c, ok ? g + (size_t)r * ld + kc + c : g, ok);
    }
  }
}

// A BM x BN tile of A B^T held in registers, built chunk by chunk. In
// double, WMR is the warps' rows (below).
template <typename T, int BM, int BN, int WMR = (BM >= 64 ? 2 : 1)>
struct Tile;

// double: eight warps in a WM x WN grid, each a (BM/WM) x (BN/WN) tile of
// mma.sync.m16n8k4 f64 (the FP64 tensor cores; m8n8k4 runs at half their
// rate on an H100). Fragments: A (16x4) lane -> rows (lane/4, lane/4 + 8),
// column lane%4; B (4x8) lane -> (lane%4, lane/4); C (16x8) lane -> rows
// (lane/4, lane/4 + 8), columns 2*(lane%4) + {0,1}.
template <int BM, int BN, int WMR> struct Tile<double, BM, BN, WMR> {
  static constexpr int WM = WMR, WN = GEMM_THREADS / 32 / WM;
  static constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  static_assert(MI * 16 * WM == BM && NI * 8 * WN == BN, "warp grid");
  double acc[MI][NI][4];

  __device__ __forceinline__ int m0() const {
    return (threadIdx.x / 32 / WN) * (MI * 16);
  }
  __device__ __forceinline__ int n0() const {
    return (threadIdx.x / 32 % WN) * (NI * 8);
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(m0() + 16 * i + g + 8 * (e / 2), n0() + 8 * j + 2 * q + e % 2,
            acc[i][j][e]);
  }
  template <class F>
  __device__ __forceinline__ void init(F f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] =
              f(m0() + 16 * i + g + 8 * (e / 2), n0() + 8 * j + 2 * q + e % 2);
  }
  // acc += A B^T (acc -= with NEG) over one chunk: A as BM rows of KC, B
  // as BN rows of KC (row stride CHUNK_LD both), or with SLB > 0 B as KC
  // rows of the tile's BN columns (row stride SLB), the inverse's A B.
  template <bool NEG, int SLB = 0>
  __device__ __forceinline__ void step(const double* sa, const double* sb) {
    constexpr int SL = CHUNK_LD;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const double* pa = sa + (m0() + g) * SL + q;
    const double* pb =
        SLB ? sb + q * SLB + n0() + g : sb + (n0() + g) * SL + q;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      double a[MI][2], b[NI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double v = pa[(16 * i + 8 * h) * SL + kk];
          a[i][h] = NEG ? -v : v;
        }
#pragma unroll
      for (int j = 0; j < NI; ++j)
        b[j] = SLB ? pb[kk * SLB + 8 * j] : pb[8 * j * SL + kk];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
              "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
              : "+d"(acc[i][j][0]), "+d"(acc[i][j][1]), "+d"(acc[i][j][2]),
                "+d"(acc[i][j][3])
              : "d"(a[i][0]), "d"(a[i][1]), "d"(b[j]));
    }
  }
};

// float: FFMA on the CUDA cores, threads in a 16 x 16 grid, each an
// (BM/16) x (BN/16) register tile with rows strided by 16 and columns by 16.
// No TF32.
template <int BM, int BN, int WMR> struct Tile<float, BM, BN, WMR> {
  static constexpr int RM = BM / 16, RN = BN / 16;
  static_assert(GEMM_THREADS == 256, "16 x 16 threads");
  float acc[RM][RN];

  template <class F>
  __device__ __forceinline__ void init(F f) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int p = 0; p < RM; ++p)
#pragma unroll
      for (int q = 0; q < RN; ++q) acc[p][q] = f(tr + 16 * p, tc + 16 * q);
  }
  // B's layout as in the double tile's step
  template <bool NEG, int SLB = 0>
  __device__ __forceinline__ void step(const float* sa, const float* sb) {
    constexpr int SL = CHUNK_LD;
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float x[RM], y[RN];
#pragma unroll
      for (int p = 0; p < RM; ++p)
        x[p] = NEG ? -sa[(tr + 16 * p) * SL + kk] : sa[(tr + 16 * p) * SL + kk];
#pragma unroll
      for (int q = 0; q < RN; ++q)
        y[q] = SLB ? sb[kk * SLB + tc + 16 * q] : sb[(tc + 16 * q) * SL + kk];
#pragma unroll
      for (int p = 0; p < RM; ++p)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
    }
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int p = 0; p < RM; ++p)
#pragma unroll
      for (int q = 0; q < RN; ++q) f(tr + 16 * p, tc + 16 * q, acc[p][q]);
  }
};

// tile = init + A B^T (or init - A B^T with NEG) over the NB columns of A
// and B (row strides lda, ldb; rows past arows / brows read as zero), with
// STAGES chunks of KC columns in flight through shared memory. The initial
// value comes from init(r, c), read while the first chunks are in flight.
template <bool NEG, int STAGES, typename T, int BM, int BN, class F>
__device__ __forceinline__ void product_nt(Tile<T, BM, BN>& tile, T* smem,
                                           const T* A, size_t lda, int arows,
                                           const T* B, size_t ldb, int brows,
                                           bool vec, F init) {
  constexpr int SL = CHUNK_LD, STAGE = (BM + BN) * SL, NCH = NB / KC;
  static_assert(STAGES >= 2 && STAGES <= NCH, "stages");
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load_chunk<T, BM>(smem + c * STAGE, A, lda, arows, NB, c * KC, vec);
    load_chunk<T, BN>(smem + c * STAGE + BM * SL, B, ldb, brows, NB, c * KC,
                      vec);
    cp_commit();
  }
  tile.init(init);
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    const int next = c + STAGES - 1;
    if (next < NCH) {
      T* buf = smem + (next % STAGES) * STAGE;
      load_chunk<T, BM>(buf, A, lda, arows, NB, next * KC, vec);
      load_chunk<T, BN>(buf + BM * SL, B, ldb, brows, NB, next * KC, vec);
    }
    cp_commit();  // possibly empty: one group per iteration
    cp_wait<STAGES - 1>();
    __syncthreads();
    const T* cur = smem + (c % STAGES) * STAGE;
    tile.template step<NEG>(cur, cur + BM * SL);
    __syncthreads();
  }
}

// X <- X inv(L_kk)^T for the `rest` rows below the diagonal block at k, in
// place: each block owns PANEL_ROWS whole rows of the panel and has read
// all of them before it writes.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
panel_product(T* __restrict__ a, const T* __restrict__ work, int n, int k,
              int rest, const unsigned char* __restrict__ skip) {
  if (skipped(skip)) return;
  a = batch_matrix(a, n);
  const T* __restrict__ inv = batch_work(work);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int r0 = blockIdx.x * PANEL_ROWS;
  const int rows = rest - r0 < PANEL_ROWS ? rest - r0 : PANEL_ROWS;
  T* X = a + (size_t)(k + NB + r0) * n + k;
  Tile<T, PANEL_ROWS, NB> tile;
  product_nt<false, PANEL_STAGES>(tile, smem, X, (size_t)n, rows, inv,
                                  (size_t)NB, NB, n % (16 / sizeof(T)) == 0,
                                  [](int, int) { return T(0); });
  tile.each([&](int r, int c, T v) {
    if (r < rows) X[(size_t)r * n + c] = v;
  });
}

// A22 -= X X^T on the lower TS x TS tiles of the trailing matrix (rows and
// columns k+NB .. n-1), tiles x = bi (bi + 1) / 2 + bj, bj <= bi.
// Persistent: block b takes tiles b, b + gridDim.x, ... The first
// `diag_tiles` make up the next diagonal block; each adds one to *ready when
// done, for the factor_diag launched beside this kernel.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
trailing_update(T* __restrict__ a, int n, int k, int rest, int diag_tiles,
                T* __restrict__ work, const unsigned char* __restrict__ skip) {
  if (skipped(skip)) return;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  a = batch_matrix(a, n);
  unsigned* __restrict__ ready = ready_counter(batch_work(work));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int off = k + NB, tiles = (rest + TS - 1) / TS;
  const T* P = a + (size_t)off * n + k;
  for (int x = blockIdx.x; x < tiles * (tiles + 1) / 2; x += gridDim.x) {
    int bi, bj;
    tri_tile(x, bi, bj);
    const int rmax = rest - bi * TS, cmax = rest - bj * TS;
    T* C = a + (size_t)(off + bi * TS) * n + off + bj * TS;
    const int diag = (bi - bj) * TS;  // c <= r + diag: on or below the diagonal
    auto kept = [&](int r, int c) {
      return r < rmax && c < cmax && c <= r + diag;
    };
    Tile<T, TS, TS> tile;
    product_nt<true, TRAIL_STAGES>(
        tile, smem, P + (size_t)bi * TS * n, (size_t)n, rmax < TS ? rmax : TS,
        P + (size_t)bj * TS * n, (size_t)n, cmax < TS ? cmax : TS,
        n % (16 / sizeof(T)) == 0,
        [&](int r, int c) { return kept(r, c) ? C[(size_t)r * n + c] : T(0); });
    tile.each([&](int r, int c, T v) {
      if (kept(r, c)) C[(size_t)r * n + c] = v;
    });
    if (x < diag_tiles) {
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(ready, 1u);
    }
  }
}

// ── The explicit inverse X = inv(L) of a lower factor ──────────────────
//
// The Schur solver turns each factor into its inverse, so that a back-solve
// is two matrix-vector products. The reference leaves that to XLA's
// triangular solve against the identity (conicip_tpu/ops/cholesky.py
// tri_inv); as a library call on the card it is a trsm of n^3 operations,
// which uses nothing of the identity's zero upper triangle. The inverse
// needs n^3/3 operations: 0.0006 ms at n = 500 on the FP64 tensor cores,
// and its bytes (L read, X written) 0.0012 ms. Below n = 1000 the time is
// the chain of products that each wait on the last, and each link's
// staging of its operands.
//
// Block form over the factor's 128-wide panels, D = blockdiag(L_ii):
//   X_ii = inv(L_ii)                   inv_diag: every diagonal block at
//                                      once, as factor_diag inverts its
//                                      block (four leaves, then recursion
//                                      on halves), in shared memory;
//   W_i,0:i = X_ii L_i,0:i             inv_w: every block row at once (the
//                                      rows of inv(D) L), into the scratch
//                                      W; and the zeros of X's strict upper
//                                      triangle right of the diagonal blocks;
//   X_i,0:i = -W_i,0:i X_0:i,0:i       inv_step: block row i once the rows
//                                      above it are done, a block for each
//                                      INV_ROWS x INV_COLS tile of it.
// So n <= 128 is one launch and a larger order ceil(n / 128) + 1. The chain
// is the steps, each one product whose depth i0 - c0 starts at its strip's
// first column (X being lower triangular).
// The products run on the FP64 tensor cores (mma.sync.m16n8k4.f64) in
// double and on FFMA in float, as the factor's. A stack is the grids'
// second dimension, a matrix to blockIdx.y, so a non-finite L (a failed
// factor) gives a non-finite X and touches no other matrix.

constexpr int INV_COLS = 32;  // columns of X an inv_w or inv_step tile takes
// their row stride in shared memory: 8 banks apart in double from row to
// row, so that the B fragments of mma.sync come without bank conflicts
constexpr int INV_LD = INV_COLS + 4;
constexpr int INV_STAGES = 3;  // chunks in flight
// Rows of an inv_w or inv_step tile: each link of the chain waits on its
// operands' staging, which short tiles shorten; at n = 500 in double on an
// H100 80GB HBM3, tiles of 32 rows took 0.59 x the time of tiles of 128 on
// one matrix, and on a stack of 64 0.86 x (1.05 x tiles of 64). In double,
// 2 x 4 warps of 16 x 8.
constexpr int INV_ROWS = 32;
template <typename T>
using InvTile = Tile<T, INV_ROWS, INV_COLS, 2>;

template <typename T>
constexpr size_t inv_smem() {
  return (size_t)INV_STAGES * (INV_ROWS * CHUNK_LD + KC * INV_LD) * sizeof(T);
}

template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

// Stage rows kc .. kc+KC-1 of g (row stride ld), its first INV_COLS
// columns, into s (row stride INV_LD); rows from `rows` on read as zero.
template <typename T>
__device__ __forceinline__ void load_b(T* s, const T* g, size_t ld, int rows,
                                       int kc, bool vec) {
  constexpr int VEC = 16 / sizeof(T), W = INV_COLS;
  if (vec) {
    for (int e = threadIdx.x; e < KC * W / VEC; e += GEMM_THREADS) {
      const int r = e / (W / VEC), c = e % (W / VEC) * VEC;
      const bool ok = kc + r < rows;
      cp_async16(s + r * INV_LD + c, ok ? g + (size_t)(kc + r) * ld + c : g,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < KC * W; e += GEMM_THREADS) {
      const int r = e / W, c = e % W;
      const bool ok = kc + r < rows;
      cp_async(s + r * INV_LD + c, ok ? g + (size_t)(kc + r) * ld + c : g,
               ok);
    }
  }
}

// tile = A B over `nch` chunks of KC: A is INV_ROWS rows of a, B INV_COLS
// columns of b, staged by load_chunk and load_b with their limits, INV_STAGES
// chunks in flight.
template <typename T>
__device__ __forceinline__ void product_nn(InvTile<T>& tile, T* smem, int nch,
                                           const T* a, int arows, int acols,
                                           const T* b, int brows, int n,
                                           bool vec) {
  constexpr int STAGE = INV_ROWS * CHUNK_LD + KC * INV_LD;
  auto stage = [&](int c) {
    T* buf = smem + (c % INV_STAGES) * STAGE;
    load_chunk<T, INV_ROWS>(buf, a, (size_t)n, arows, acols, c * KC, vec);
    load_b(buf + INV_ROWS * CHUNK_LD, b, (size_t)n, brows, c * KC, vec);
  };
#pragma unroll
  for (int c = 0; c < INV_STAGES - 1; ++c) {
    if (c < nch) stage(c);
    cp_commit();
  }
  tile.init([](int, int) { return T(0); });
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    if (c + INV_STAGES - 1 < nch) stage(c + INV_STAGES - 1);
    cp_commit();  // possibly empty: one group per iteration
    cp_wait<INV_STAGES - 1>();
    __syncthreads();
    const T* cur = smem + (c % INV_STAGES) * STAGE;
    tile.template step<false, INV_LD>(cur, cur + INV_ROWS * CHUNK_LD);
    __syncthreads();
  }
}

// X_kk = inv(L_kk) for the diagonal block blockIdx.x of matrix blockIdx.y,
// its strict upper triangle written as zeros.
template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS)
inv_diag(const T* __restrict__ L, T* __restrict__ X, int n) {
  L = batch_matrix(L, n);
  X = batch_matrix(X, n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // L_kk, then the inverse
  T* V = S + NB * LD;                     // 4 leaf inverses, LEAF x VL
  T* P = V + 4 * LEAF * VL;               // products, 64 x PL
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  constexpr int WARPS = DIAG_THREADS / 32, RQ = NB / WARPS, CQ = NB / 32;
  const int k = blockIdx.x * NB, kb = n - k < NB ? n - k : NB;
  load_block(S, L, n, k, kb);
  __syncthreads();
  // Leaf w by warp w, right-looking: lane c holds column c of inv(L_ww),
  // s_m = delta_mc - sum_{r<m} l_mr y_r, and y_r = s_r / l_rr once the
  // rows above r are in; lane r computes 1 / l_rr for all.
  if (w < 4) {
    const T* Lw = S + LEAF * w * (LD + 1);
    T* Vw = V + w * LEAF * VL;
    const T rd = T(1) / Lw[lane * (LD + 1)];
    T sv[LEAF];
#pragma unroll
    for (int r = 0; r < LEAF; ++r) sv[r] = T(r == lane);
#pragma unroll
    for (int r = 0; r < LEAF; ++r) {
      const T y = sv[r] * __shfl_sync(0xffffffffu, rd, r);
      sv[r] = y;
#pragma unroll
      for (int m = r + 1; m < LEAF; ++m) sv[m] -= Lw[m * LD + r] * y;
    }
#pragma unroll
    for (int r = 0; r < LEAF; ++r)
      Vw[r * VL + lane] = r >= lane ? sv[r] : T(0);
  }
  __syncthreads();
  invert_from_leaves(S, V, P);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int cc = 0; cc < CQ; ++cc) {
      const int r = w + WARPS * q, c = lane + 32 * cc;
      const int br = r / LEAF, bc = c / LEAF;
      if (r < kb && c < kb)
        X[(size_t)(k + r) * n + k + c] =
            c > r ? T(0)
                  : (br == bc ? V[br * LEAF * VL + (r % LEAF) * VL + c % LEAF]
                              : S[r * LD + c]);
    }
}

// Column strip s of block row i >= 1 from x = 2 i (i - 1) + s, s < 4 i
// (NB / INV_COLS = 4 strips a block row): the strips of all block rows.
__device__ __forceinline__ void row_strip(int x, int& i, int& s) {
  i = (int)((1.0 + sqrt(1.0 + 2.0 * x)) * 0.5);
  while (2 * i * (i + 1) <= x) ++i;
  while (2 * i * (i - 1) > x) --i;
  s = x - 2 * i * (i - 1);
}

// W_i,0:i = X_ii L_i,0:i, tile (rows r0 .. r0+INV_ROWS-1 of block row i,
// columns c0 .. c0+INV_COLS-1) per block, its depth min(kb, r0 + INV_ROWS)
// (X_ii lower triangular). Then every block stores its share of the zeros
// of X's strict upper triangle right of the diagonal blocks, a warp a row.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
inv_w(const T* __restrict__ L, T* __restrict__ X, T* __restrict__ W, int n) {
  L = batch_matrix(L, n);
  X = batch_matrix(X, n);
  W = batch_matrix(W, n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int RT = NB / INV_ROWS;
  int i, s;
  row_strip(blockIdx.x / RT, i, s);
  const int i0 = i * NB, kb = n - i0 < NB ? n - i0 : NB;
  const int r0 = blockIdx.x % RT * INV_ROWS, c0 = s * INV_COLS;
  const bool vec = n % (16 / sizeof(T)) == 0;
  if (r0 < kb) {
    const int depth = kb < r0 + INV_ROWS ? kb : r0 + INV_ROWS;
    InvTile<T> tile;
    product_nn(tile, smem, (depth + KC - 1) / KC,
               X + (size_t)(i0 + r0) * n + i0, kb - r0, kb,
               L + (size_t)i0 * n + c0, kb, n, vec);
    tile.each([&](int r, int c, T v) {
      if (r < kb - r0) W[(size_t)(i0 + r0 + r) * n + c0 + c] = v;
    });
  }
  // rows 0 .. NB (blocks - 1) - 1 end past their diagonal block
  const int zrows = (n - 1) / NB * NB;
  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * (GEMM_THREADS / 32) + (threadIdx.x >> 5);
       r < zrows; r += gridDim.x * (GEMM_THREADS / 32)) {
    const int z0 = (r / NB + 1) * NB;
    if (vec) {
      using Z = typename Vec16<T>::type;
      constexpr int VEC = 16 / sizeof(T);
      Z* row = reinterpret_cast<Z*>(X + (size_t)r * n + z0);
      for (int c = lane; c < (n - z0) / VEC; c += 32) row[c] = Z{};
    } else {
      T* row = X + (size_t)r * n + z0;
      for (int c = lane; c < n - z0; c += 32) row[c] = T(0);
    }
  }
}

// Block row i (rows i0 ..) of X, tile (rows r0 .. r0+INV_ROWS-1, columns
// c0 .. c0+INV_COLS-1, c0 < i0) per block: -W_i,c0:i0 X_c0:i0,c0:. Reads
// the rows of X above i0, which the launches before wrote.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
inv_step(const T* __restrict__ W, T* __restrict__ X, int n, int i0) {
  W = batch_matrix(W, n);
  X = batch_matrix(X, n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int RT = NB / INV_ROWS;
  const int kb = n - i0 < NB ? n - i0 : NB;
  const int r0 = blockIdx.x % RT * INV_ROWS, c0 = blockIdx.x / RT * INV_COLS;
  if (r0 >= kb) return;
  InvTile<T> tile;
  product_nn(tile, smem, (i0 - c0) / KC, W + (size_t)(i0 + r0) * n + c0,
             kb - r0, i0 - c0, X + (size_t)c0 * n + c0, i0 - c0, n,
             n % (16 / sizeof(T)) == 0);
  tile.each([&](int r, int c, T v) {
    if (r < kb - r0) X[(size_t)(i0 + r0 + r) * n + c0 + c] = -v;
  });
}

// X = inv(L) for `batch` lower factors of order n, contiguous in L and X;
// W is scratch of the same size (unused, and may be null, when n <= NB).
template <typename T>
cudaError_t tri_inverse(const T* L, T* X, T* W, int batch, int n,
                        cudaStream_t st) {
  if (batch <= 0 || batch > 65535 || n <= 0 || (n > NB && W == nullptr))
    return cudaErrorInvalidValue;
  static_assert(NB % INV_COLS == 0 && INV_COLS % KC == 0 &&
                NB % INV_ROWS == 0, "whole strips and row tiles");
  constexpr int RT = NB / INV_ROWS;
  constexpr size_t smem = inv_smem<T>();
  const int blocks = (n + NB - 1) / NB;
  cudaError_t err = cudaFuncSetAttribute(
      inv_diag<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)diag_smem<T>());
  if (err == cudaSuccess && blocks > 1)
    err = cudaFuncSetAttribute(
        inv_w<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && blocks > 1)
    err = cudaFuncSetAttribute(
        inv_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  inv_diag<T><<<dim3(blocks, batch), DIAG_THREADS, diag_smem<T>(), st>>>(
      L, X, n);
  err = cudaGetLastError();
  if (blocks == 1 || err != cudaSuccess) return err;
  // the strips of block rows 1 .. blocks - 1: 2 blocks (blocks - 1)
  inv_w<T><<<dim3(2 * blocks * (blocks - 1) * RT, batch), GEMM_THREADS, smem,
             st>>>(L, X, W, n);
  err = cudaGetLastError();
  for (int b = 1; b < blocks && err == cudaSuccess; ++b) {
    inv_step<T><<<dim3(b * (NB / INV_COLS) * RT, batch), GEMM_THREADS, smem,
                  st>>>(W, X, n, b * NB);
    err = cudaGetLastError();
  }
  return err;
}

// Multiprocessor count of a device, read once: the launches may be captured
// into a CUDA graph, and then they make no call but the launches themselves
// and the attribute settings.
int multiprocessors(int dev, cudaError_t& err) {
  static int cached[64] = {};
  if (dev < 0 || dev >= 64) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cached[dev] == 0)
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  return cached[dev];
}

// Factor `batch` matrices of order n, contiguous in `in` and `out`. The
// batch is the grids' second dimension, so a stack costs the launches of one
// matrix. With one matrix the trailing update is a persistent grid on all
// SMs but one (left to the factor_diag beside it); with a stack the SMs are
// shared out between the matrices, at least one block each. `skip`, when
// not null, holds one flag per matrix on the device: a flagged matrix's
// `out` is left as it was (every launch below returns at once for it).
template <typename T>
cudaError_t cholesky(const T* in, T* out, T* work, int batch, int n,
                     const unsigned char* skip, cudaStream_t st) {
  if (batch <= 0 || batch > 65535 || n <= 0 || (n > NB && work == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      factor_diag<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)diag_smem<T>());
  if (err != cudaSuccess) return err;
  if (n <= NB) {
    factor_diag<T><<<dim3(1, batch), DIAG_THREADS, diag_smem<T>(), st>>>(
        in, out, nullptr, n, 0, n, false, false, 0u, skip);
    return cudaGetLastError();
  }
  constexpr size_t panel_smem = gemm_smem<T>(PANEL_ROWS, NB, PANEL_STAGES);
  constexpr size_t tile_smem = gemm_smem<T>(TS, TS, TRAIL_STAGES);
  static_assert(NB % TS == 0, "the diagonal block is whole tiles");
  err = cudaFuncSetAttribute(panel_product<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)panel_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trailing_update<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tile_smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) sms = multiprocessors(dev, err);
  if (err != cudaSuccess) return err;
  const int free_sms = sms > 1 ? sms - 1 : 1;
  const int resident = free_sms / batch > 1 ? free_sms / batch : 1;

  const size_t total = (size_t)n * n;
  const int copy_blocks =
      (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  copy_lower<T><<<dim3(copy_blocks, batch), 256, 0, st>>>(in, out, n, work,
                                                          skip);
  factor_diag<T><<<dim3(1, batch), DIAG_THREADS, diag_smem<T>(), st>>>(
      out, out, work, n, 0, NB, true, false, 0u, skip);
  err = cudaGetLastError();
  // Panel k: its rows below are solved; then the trailing update, whose
  // first tiles are the next diagonal block, and beside it (programmatic
  // dependent launch) the factor of that block, which waits for those
  // tiles, and for the whole trailing update before it ends.
  unsigned target = 0;
  for (int k = 0; k + NB < n && err == cudaSuccess; k += NB) {
    const int rest = n - k - NB;
    const int kb = rest < NB ? rest : NB;  // the next panel's width
    panel_product<T><<<dim3((rest + PANEL_ROWS - 1) / PANEL_ROWS, batch),
                       GEMM_THREADS, panel_smem, st>>>(out, work, n, k, rest,
                                                       skip);
    const int tiles = (rest + TS - 1) / TS, tk = (kb + TS - 1) / TS;
    const int count = tiles * (tiles + 1) / 2, diag_tiles = tk * (tk + 1) / 2;
    trailing_update<T><<<dim3(count < resident ? count : resident, batch),
                         GEMM_THREADS, tile_smem, st>>>(
        out, n, k, rest, diag_tiles, work, skip);
    target += (unsigned)diag_tiles;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, batch);
    cfg.blockDim = dim3(DIAG_THREADS);
    cfg.dynamicSmemBytes = diag_smem<T>();
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, factor_diag<T>, (const T*)out, out, work, n,
                             k + NB, kb, rest > NB, true, target, skip);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Plain C entry points, bound with ctypes. `in` and `out` are distinct
// row-major contiguous device buffers, n x n for the single entries and
// batch x n x n for the batched ones; `work` is a scratch buffer of the same
// type, needed only when n > 128 (may be null below): 128 x 128 + 1 elements
// for a single matrix, 128 x 128 + 4 for each matrix of a batch. `skip` is
// null (factor every matrix) or a device buffer of one byte per matrix: a
// matrix whose byte is not 0 keeps what `out` held.
// Nothing is allocated and the stream is not synchronised. Returns
// cudaGetLastError() after the launches.
extern "C" int conicip_cholesky_f64(const void* in, void* out, void* work,
                                    int n, const void* skip, void* stream) {
  return (int)cholesky<double>(static_cast<const double*>(in),
                               static_cast<double*>(out),
                               static_cast<double*>(work), 1, n,
                               static_cast<const unsigned char*>(skip),
                               static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_cholesky_f32(const void* in, void* out, void* work,
                                    int n, const void* skip, void* stream) {
  return (int)cholesky<float>(static_cast<const float*>(in),
                              static_cast<float*>(out),
                              static_cast<float*>(work), 1, n,
                              static_cast<const unsigned char*>(skip),
                              static_cast<cudaStream_t>(stream));
}

// The batched entries: every matrix of the stack gets the factor the single
// entry gives it (a failed one is NaN from its failing pivot on, the others
// untouched), in the launches of one matrix of order n.
extern "C" int conicip_cholesky_batched_f64(const void* in, void* out,
                                            void* work, int batch, int n,
                                            const void* skip, void* stream) {
  return (int)cholesky<double>(static_cast<const double*>(in),
                               static_cast<double*>(out),
                               static_cast<double*>(work), batch, n,
                               static_cast<const unsigned char*>(skip),
                               static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_cholesky_batched_f32(const void* in, void* out,
                                            void* work, int batch, int n,
                                            const void* skip, void* stream) {
  return (int)cholesky<float>(static_cast<const float*>(in),
                              static_cast<float*>(out),
                              static_cast<float*>(work), batch, n,
                              static_cast<const unsigned char*>(skip),
                              static_cast<cudaStream_t>(stream));
}

// The inverse's entries: X = inv(L) for the lower factors in L (the
// strict upper triangle is not read), n x n for the single entries and
// batch x n x n for the batched ones, distinct row-major contiguous device
// buffers; W is a scratch buffer of X's size, needed only when n > 128 (may
// be null below). Nothing is allocated and the stream is not synchronised.
// Returns cudaGetLastError() after the launches.
extern "C" int conicip_tri_inv_f64(const void* L, void* X, void* W, int n,
                                   void* stream) {
  return (int)tri_inverse<double>(
      static_cast<const double*>(L), static_cast<double*>(X),
      static_cast<double*>(W), 1, n, static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_tri_inv_f32(const void* L, void* X, void* W, int n,
                                   void* stream) {
  return (int)tri_inverse<float>(
      static_cast<const float*>(L), static_cast<float*>(X),
      static_cast<float*>(W), 1, n, static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_tri_inv_batched_f64(const void* L, void* X, void* W,
                                           int batch, int n, void* stream) {
  return (int)tri_inverse<double>(
      static_cast<const double*>(L), static_cast<double*>(X),
      static_cast<double*>(W), batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int conicip_tri_inv_batched_f32(const void* L, void* X, void* W,
                                           int batch, int n, void* stream) {
  return (int)tri_inverse<float>(
      static_cast<const float*>(L), static_cast<float*>(X),
      static_cast<float*>(W), batch, n, static_cast<cudaStream_t>(stream));
}

// Edges of a captured CUDA graph (a cudaGraph_t): all of them, and those
// that are programmatic (a programmatic dependent launch kept as such by
// the capture). Returns the CUDA error of the query.
extern "C" int conicip_graph_edges(void* graph, long long* total,
                                   long long* programmatic) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &count);
  *total = (long long)count;
  *programmatic = 0;
  if (err != cudaSuccess || count == 0) return (int)err;
  cudaGraphNode_t* from = new cudaGraphNode_t[count];
  cudaGraphNode_t* to = new cudaGraphNode_t[count];
  cudaGraphEdgeData* data = new cudaGraphEdgeData[count];
  err = cudaGraphGetEdges_v2(g, from, to, data, &count);
  for (size_t i = 0; err == cudaSuccess && i < count; ++i)
    if (data[i].type == cudaGraphDependencyTypeProgrammatic) ++*programmatic;
  delete[] from;
  delete[] to;
  delete[] data;
  return (int)err;
}
