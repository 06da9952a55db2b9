// The R cones' share of one interior-point iteration, as four kernels.
//
// On the TPU, XLA fused the elementwise cone work of an iteration into a
// few fusions; the port issued each of its operations as its own launch.
// For a spec whose cones are all R (ConeSpec.only_r) these kernels carry
// that work, each one pass over the (B, m) vectors of a stack of B
// instances (a single solve is B = 1):
//
//   r_scaling  the NT scaling r_d = sqrt(s / v), 1 / r_d, the scaled point
//              lam = r_d v and lam o lam, and mubar = v.s per instance.
//              Replaces conicip_tpu_torch/cones/scaling.py:129 (nt_scaling),
//              :176 (nt_inv_adjoint), solver/ipm.py lam = F z.v and
//              residual_block's cone_prod(lam, lam) and dot(z.v, z.s);
//              reference conicip_tpu/cones/scaling.py:113,
//              conicip_tpu/solver/ipm.py:261.
//   r_reduce4  the 4x4 -> 3x3 reduction around the caller's 3x3 solve
//              (make_solve4): before it t1 = r_d (r.s / lam) and r.v + t1,
//              after it ds = t1 - r_d (r_d dv). Reference
//              conicip_tpu/solver/ipm.py:345.
//   r_comp     the complementarity vectors of take_step: the corrector's
//              s-row rleft.s - (-(F^-T ds)(F dv) + sigma mu e), the
//              refinement residual's s-row lam (F dv) + lam (F^-T ds), and
//              the Gondzio trial w = (lam - a F dv)(lam - a F^-T ds) with
//              its correction -q, q = max(min(max(w, lo), hi) - w, -hi).
//              Reference conicip_tpu/solver/ipm.py:703, :796,
//              conicip_tpu/cones/algebra.py:350.
//   r_step     the fraction-to-boundary step: both min-ratios
//              min over d > 0 of x / d for (v, dv scale) and (s, ds scale),
//              each clamped to 1, their minimum, whether dv and ds are
//              finite, and on the predictor the four dots of fts and fts
//              itself. Reference conicip_tpu/cones/algebra.py:218,
//              conicip_tpu/solver/ipm.py:399.
//
// None replaces a TPU kernel: the JAX package wrote this math as plain jnp
// code. Each replaces the sequence of PyTorch launches the port issued for
// it; their plain twins (ops/rcone.py) issue that sequence and are what the
// CPU runs.
//
// What bounds them: bytes. Each reads its vectors once and writes its
// outputs once (a few flops an element), so the least time is those bytes
// over the card's 3.35 TB/s; at the solver's widths (m of a few thousand)
// that is 10-300 ns, below the fixed cost of one node of a CUDA graph
// (about 2 us), so what a kernel can still win is the time between the
// node's start and its last store: how many SMs share the work and how
// many device-memory round trips each thread waits for in turn. Every
// kernel keeps its reductions in a fixed tree with no atomics, so a result
// is the same bits at every launch of one shape (the device loop is held
// bit for bit against the eager loop). Elementwise arithmetic is the
// correctly rounded intrinsics, which the compiler may not contract into
// an FMA, so every elementwise output, and the step alpha with its flag
// ok, is the bits of the plain sequence, which rounds each operation on
// its own; only the reduced values (mubar, the dots, fts) differ from the
// plain twin's, in summation order (sums accumulate in double for both
// dtypes). max/min/clamp propagate NaN as PyTorch's CUDA kernels do.
//
// r_reduce4 and r_comp (elementwise, no reduction): a 2-D grid,
// (ceil(m / 256), B), so that one instance spreads over m / 256 SMs (32
// at m = 8192; the (64, 1000) stack is 256 blocks for the card's 132
// SMs). Each thread owns one 16-byte vector of every operand (2 doubles
// or 4 floats, so a block is 128 or 64 threads), issues all its loads
// before any arithmetic, and so waits for device memory once; the ragged
// end of a row is loaded and stored by scalars. The vector loads and
// stores are taken only where every pointer and every row start is
// 16-byte aligned (the wrapper decides from the pointers, the row strides
// and the dtype: the VEC template); else the same threads take the same
// elements by scalar accesses. r_comp's three modes are template
// instances of one kernel; each block reads an instance's sigma mu and
// atil once. What bounds them: the graph node's fixed cost and one round
// trip to device memory; the bytes only for stacks far larger than the
// solver's.
//
// r_step (per-instance reductions: two NaN-winning mins, the finite AND
// and on the predictor four dots) and r_scaling (elementwise outputs and
// one sum, mubar): one thread-block cluster of C blocks per instance
// (grid (C, B), C in 1, 2, 4, 8, a function of (B, m, dtype) alone,
// chosen by the wrapper so that a thread holds about one vector),
// launched by cudaLaunchKernelEx. Each thread issues the loads of two
// trips over the row before their arithmetic (r_scaling stores its four
// outputs as vectors where aligned); each block reduces its share in
// registers, then by one shuffle tree per warp and one pass through
// shared memory (one barrier), and stores its partial into its slot of
// block rank 0's shared memory (distributed shared memory); after one
// cluster barrier (a block barrier for a cluster of one) rank 0 joins
// the slots in rank order and writes the results, while the other blocks
// leave. (Pushing the partials saves 0.9-2.4 us a call against rank 0
// reading them remotely behind a second cluster barrier, with one trip
// over the row at a time.) One launch, no second pass, no atomics, no
// counter in device memory; the order of every sum is fixed by (B, m,
// dtype) and is the same on the vector and the scalar path, so it gives
// the same bits at every replay of a captured graph. What bounds them:
// not the bytes but a chain of dependent latencies after the node's
// fixed cost: one round trip to device memory per two trips over the row
// (one at m <= 4096 in f64), the correctly rounded divisions and square
// root of each element (two divisions for r_step, a division, a square
// root and a division in turn for r_scaling), the shuffle levels, the
// block barrier, the cluster barrier and rank 0's join.
//
// C interface, loaded with ctypes by ops/rcone_kernel.py: every pointer a
// (B, m) vector or a (B,) per-instance value on the current device,
// launched on `stream`, not synchronised; the inputs rows of unit stride
// along m, `s*` elements apart (0: one row shared by the stack), the
// outputs contiguous; the launch plan (grid, threads, cluster, VEC) given
// by the wrapper (ops/rcone_kernel.py:launch_plan). Each returns the
// launch's error, or cudaGetLastError() after its one launch (0 on
// success); a launch the card refuses (a cluster it cannot place, say) is
// that error, and nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// threads of a block of r_step and r_scaling, and the portable largest
// cluster
constexpr int CLUSTER_THREADS = 128;
constexpr int CLUSTER_WARPS = CLUSTER_THREADS / 32;
constexpr int MAX_CLUSTER = 8;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
// a - b is a + (-b) in IEEE arithmetic, signed zeros included
template <typename T>
__device__ __forceinline__ T sub(T a, T b) {
  return add(a, -b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double fmx(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmn(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float fmn(float a, float b) { return fminf(a, b); }

// torch.maximum / torch.minimum / clamp on CUDA: a NaN operand wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : fmx(a, b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : fmn(a, b));
}

template <typename T>
__device__ __forceinline__ T inf() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// not NaN and not infinite (|x| < inf is false for both)
__device__ __forceinline__ bool finite(double x) {
  return fabs(x) < inf<double>();
}
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) < inf<float>();
}

// One 16-byte vector of T: its CUDA type and its lanes.
template <typename T>
struct Lanes;
template <>
struct Lanes<double> {
  using V = double2;
  static constexpr int N = 2;
};
template <>
struct Lanes<float> {
  using V = float4;
  static constexpr int N = 4;
};

__device__ __forceinline__ void split(const double2& q, double* a) {
  a[0] = q.x;
  a[1] = q.y;
}
__device__ __forceinline__ void split(const float4& q, float* a) {
  a[0] = q.x;
  a[1] = q.y;
  a[2] = q.z;
  a[3] = q.w;
}
__device__ __forceinline__ double2 join(const double* a) {
  return make_double2(a[0], a[1]);
}
__device__ __forceinline__ float4 join(const float* a) {
  return make_float4(a[0], a[1], a[2], a[3]);
}

// Elements i .. i + n - 1 of a row (n <= N, the lanes below m): one
// 16-byte load where VEC and the whole vector lies in the row, else n
// scalar loads; lanes from n on are left as they are.
template <typename T, bool VEC>
__device__ __forceinline__ void load(T* a, const T* __restrict__ row,
                                     long long i, int n) {
  if (VEC && n == Lanes<T>::N) {
    split(__ldg(reinterpret_cast<const typename Lanes<T>::V*>(row + i)), a);
  } else {
#pragma unroll
    for (int k = 0; k < Lanes<T>::N; ++k)
      if (k < n) a[k] = row[i + k];
  }
}
template <typename T, bool VEC>
__device__ __forceinline__ void store(T* __restrict__ row, long long i,
                                      int n, const T* a) {
  if (VEC && n == Lanes<T>::N) {
    *reinterpret_cast<typename Lanes<T>::V*>(row + i) = join(a);
  } else {
#pragma unroll
    for (int k = 0; k < Lanes<T>::N; ++k)
      if (k < n) row[i + k] = a[k];
  }
}

// The n loaded lanes of one vector of v and s at element i of row `row`:
// r_d = sqrt(s / v), 1 / r_d, lam = r_d v and lam o lam stored (as
// vectors where VEC and the whole vector lies in the row), v s added to
// acc lane by lane.
template <typename T, bool VEC>
__device__ __forceinline__ void nt_scale(const T* v, const T* s, int n,
                                         long long row, long long i,
                                         T* __restrict__ r_d,
                                         T* __restrict__ rinv,
                                         T* __restrict__ lam,
                                         T* __restrict__ lam2, double& acc) {
  constexpr int N = Lanes<T>::N;
  T r[N], ri[N], l[N], l2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= n) break;
    r[k] = root(quo(s[k], v[k]));
    l[k] = mul(r[k], v[k]);
    ri[k] = quo(T(1), r[k]);
    l2[k] = mul(l[k], l[k]);
    acc += static_cast<double>(mul(v[k], s[k]));
  }
  store<T, VEC>(r_d + row, i, n, r);
  store<T, VEC>(rinv + row, i, n, ri);
  store<T, VEC>(lam + row, i, n, l);
  store<T, VEC>(lam2 + row, i, n, l2);
}

// r_d = sqrt(s / v), 1 / r_d, lam = r_d v, lam o lam, and mubar = v.s per
// instance. Grid (C, min(B, 65535)), clusters (C, 1, 1), as r_step: the
// cluster at row by takes instances by, by + gridDim.y, ...; in trip q
// thread t of block rank r owns elements ((q C + r) blockDim.x + t) N ..
// + N - 1, taken in the order of q (two trips' loads issued together).
// Each block sums its share (the warps' trees, one barrier, warp 0's
// tree) and stores it into slot r of rank 0's shared memory; after one
// cluster barrier rank 0 adds the slots in rank order and writes mubar.
template <typename T, bool VEC>
__global__ void __launch_bounds__(CLUSTER_THREADS)
    r_scaling(const T* __restrict__ v, const T* __restrict__ s,
              T* __restrict__ r_d, T* __restrict__ rinv, T* __restrict__ lam,
              T* __restrict__ lam2, T* __restrict__ mubar, int B, int m,
              long long sv, long long ss) {
  namespace cg = cooperative_groups;
  constexpr int N = Lanes<T>::N;
  __shared__ double warps[CLUSTER_WARPS];
  __shared__ double slots[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first =
      (static_cast<long long>(rank) * blockDim.x + threadIdx.x) * N;
  const long long span = static_cast<long long>(C) * blockDim.x * N;
  double* slot = cluster.map_shared_rank(&slots[rank], 0);
  const auto barrier = [&cluster, C] {
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T *vb = v + b * sv, *sb = s + b * ss;
    const long long row = b * m;
    double acc = 0.0;
    for (long long i = first; i < m; i += 2 * span) {
      const long long j = i + span;
      const int n0 = static_cast<int>(m - i < N ? m - i : N);
      const int n1 = j < m ? static_cast<int>(m - j < N ? m - j : N) : 0;
      T v0[N], s0[N], v1[N], s1[N];
      // both trips' loads first: one wait for device memory
      load<T, VEC>(v0, vb, i, n0);
      load<T, VEC>(s0, sb, i, n0);
      load<T, VEC>(v1, vb, j, n1);
      load<T, VEC>(s1, sb, j, n1);
      nt_scale<T, VEC>(v0, s0, n0, row, i, r_d, rinv, lam, lam2, acc);
      nt_scale<T, VEC>(v1, s1, n1, row, j, r_d, rinv, lam, lam2, acc);
    }
    // the warps' trees, then one pass through shared memory
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) warps[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      double w = lane < CLUSTER_WARPS ? warps[lane] : 0.0;
#pragma unroll
      for (int o = CLUSTER_WARPS / 2; o > 0; o >>= 1)
        w += __shfl_down_sync(0xffffffffu, w, o);
      if (lane == 0) *slot = w;  // into rank 0's shared memory
    }
    // the slots' stores are seen by rank 0 after the barrier (a cluster
    // of one block needs only the block's)
    barrier();
    if (rank == 0 && threadIdx.x == 0) {
      double all = slots[0];
      for (unsigned r = 1; r < C; ++r) all += slots[r];
      mubar[b] = static_cast<T>(all);
    }
    // the next instance's stores wait until rank 0 has read these
    if (b + gridDim.y < B) barrier();
  }
}

// POST false: x = r.s, y = r.v; out = t1 = r_d (x / lam), out2 = y + t1.
// POST true:  x = t1,  y = dv;  out = ds = t1 - r_d (r_d dv).
// Grid (ceil(m / (blockDim.x N)), min(B, 65535)); thread t of block
// (bx, by) owns elements (bx blockDim.x + t) N .. + N - 1 of instances
// by, by + gridDim.y, ...; inputs s* elements apart, outputs contiguous.
template <typename T, bool POST, bool VEC>
__global__ void __launch_bounds__(128)
    r_reduce4(const T* __restrict__ x, const T* __restrict__ lam,
              const T* __restrict__ r_d, const T* __restrict__ y,
              T* __restrict__ out, T* __restrict__ out2, int B, int m,
              long long sx, long long sl, long long sr, long long sy) {
  constexpr int N = Lanes<T>::N;
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= m) return;
  const int n = static_cast<int>(m - i < N ? m - i : N);
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T xa[N], ra[N], ya[N], la[N], o[N], o2[N];
    // every load first: one wait for device memory
    load<T, VEC>(xa, x + b * sx, i, n);
    load<T, VEC>(ra, r_d + b * sr, i, n);
    load<T, VEC>(ya, y + b * sy, i, n);
    if (!POST) load<T, VEC>(la, lam + b * sl, i, n);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (POST) {
        o[k] = sub(xa[k], mul(ra[k], mul(ra[k], ya[k])));
      } else {
        o[k] = mul(ra[k], quo(xa[k], la[k]));
        o2[k] = add(ya[k], o[k]);
      }
    }
    const long long row = b * m;
    store<T, VEC>(out + row, i, n, o);
    if (!POST) store<T, VEC>(out2 + row, i, n, o2);
  }
}

enum Comp { CORRECTOR = 0, K4 = 1, GONDZIO = 2 };

// F dv = r_d dv and F^-T ds = rinv ds, then by MODE, with `a` x =
// rleft.s for the corrector and lam for the others:
//   CORRECTOR  out = x - (-(F^-T ds)(F dv) + smu)
//   K4         out = lam (F dv) + lam (F^-T ds)
//   GONDZIO    w = (lam - atil F dv)(lam - atil F^-T ds), lo = 0.1 smu,
//              hi = 10 smu, out = -max(min(max(w, lo), hi) - w, -hi)
// smu (sigma mu) and atil are per instance. Grid and threads as
// r_reduce4's: thread t of block (bx, by) owns elements (bx blockDim.x +
// t) N .. + N - 1 of instances by, by + gridDim.y, ...; inputs s*
// elements apart, the output contiguous.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(128)
    r_comp(const T* __restrict__ a, const T* __restrict__ r_d,
           const T* __restrict__ rinv, const T* __restrict__ dv,
           const T* __restrict__ ds, const T* __restrict__ smu,
           const T* __restrict__ atil, T* __restrict__ out, int B, int m,
           long long sa, long long sr, long long si, long long sdv,
           long long sds) {
  constexpr int N = Lanes<T>::N;
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= m) return;
  const int n = static_cast<int>(m - i < N ? m - i : N);
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T xa[N], ra[N], ia[N], dva[N], dsa[N], o[N];
    // every load first: one wait for device memory
    const T sm = MODE != K4 ? smu[b] : T(0);
    const T at = MODE == GONDZIO ? atil[b] : T(0);
    load<T, VEC>(xa, a + b * sa, i, n);
    load<T, VEC>(ra, r_d + b * sr, i, n);
    load<T, VEC>(ia, rinv + b * si, i, n);
    load<T, VEC>(dva, dv + b * sdv, i, n);
    load<T, VEC>(dsa, ds + b * sds, i, n);
    const T lo = mul(sm, T(0.1)), hi = mul(sm, T(10.0));
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T fdv = mul(ra[k], dva[k]);
      const T fds = mul(ia[k], dsa[k]);
      if (MODE == CORRECTOR) {
        o[k] = sub(xa[k], add(-mul(fds, fdv), sm));
      } else if (MODE == K4) {
        o[k] = add(mul(xa[k], fdv), mul(xa[k], fds));
      } else {
        const T w = mul(sub(xa[k], mul(at, fdv)), sub(xa[k], mul(at, fds)));
        o[k] = -nan_max(sub(nan_min(nan_max(w, lo), hi), w), -hi);
      }
    }
    store<T, VEC>(out + b * m, i, n, o);
  }
}

// One block's share of r_step's reductions: each block stores it into
// its slot of block rank 0's shared memory.
template <typename T>
struct StepPart {
  double d[4];
  T av, as;
  int fin;
};

// One thread's running reductions over its elements, in their order.
template <typename T, bool FTS>
struct StepAcc {
  T av, as;
  int fin;
  double d0, d1, d2, d3;

  __device__ __forceinline__ StepAcc()
      : av(inf<T>()), as(inf<T>()), fin(1), d0(0.0), d1(0.0), d2(0.0),
        d3(0.0) {}

  // the n loaded lanes of one vector of v, s, dv, ds
  __device__ __forceinline__ void take(const T* v, const T* s, const T* dv,
                                       const T* ds, int n, T sc) {
#pragma unroll
    for (int k = 0; k < Lanes<T>::N; ++k) {
      if (k >= n) break;
      fin &= finite(dv[k]) && finite(ds[k]);
      const T a = mul(dv[k], sc), c = mul(ds[k], sc);
      av = nan_min(av, a > T(0) ? quo(v[k], a) : inf<T>());
      as = nan_min(as, c > T(0) ? quo(s[k], c) : inf<T>());
      if (FTS) {
        d0 += static_cast<double>(mul(v[k], s[k]));
        d1 += static_cast<double>(mul(v[k], ds[k]));
        d2 += static_cast<double>(mul(dv[k], s[k]));
        d3 += static_cast<double>(mul(dv[k], ds[k]));
      }
    }
  }

  // the same over the lanes `o` apart, in a fixed tree (fin by a vote)
  __device__ __forceinline__ void fold(int o) {
    av = nan_min(av, __shfl_down_sync(0xffffffffu, av, o));
    as = nan_min(as, __shfl_down_sync(0xffffffffu, as, o));
    if (FTS) {
      d0 += __shfl_down_sync(0xffffffffu, d0, o);
      d1 += __shfl_down_sync(0xffffffffu, d1, o);
      d2 += __shfl_down_sync(0xffffffffu, d2, o);
      d3 += __shfl_down_sync(0xffffffffu, d3, o);
    }
  }

  __device__ __forceinline__ void put(StepPart<T>* p) const {
    p->av = av;
    p->as = as;
    p->fin = fin;
    p->d[0] = d0;
    p->d[1] = d1;
    p->d[2] = d2;
    p->d[3] = d3;
  }
  __device__ __forceinline__ void get(const StepPart<T>& p) {
    av = p.av;
    as = p.as;
    fin = p.fin;
    d0 = p.d[0];
    d1 = p.d[1];
    d2 = p.d[2];
    d3 = p.d[3];
  }
  // another block's partial after this one's
  __device__ __forceinline__ void join(const StepPart<T>& p) {
    av = nan_min(av, p.av);
    as = nan_min(as, p.as);
    fin &= p.fin;
    if (FTS) {
      d0 += p.d[0];
      d1 += p.d[1];
      d2 += p.d[2];
      d3 += p.d[3];
    }
  }
};

// alpha = min(clamp(min_{dv' > 0} v / dv', max=1), clamp(min_{ds' > 0}
// s / ds', max=1)) over dv' = dv scale, ds' = ds scale (each rounded
// before the division, as the plain sequence rounds it), ok = every
// entry of dv and ds finite; with FTS also dots = (v.s, v.ds, dv.s,
// dv.ds) and fts = ((v.s - alpha v.ds) - alpha dv.s) + alpha^2 dv.ds.
// Grid (C, min(B, 65535)), clusters (C, 1, 1): the cluster at row by
// takes instances by, by + gridDim.y, ...; in trip q thread t of block
// rank r owns elements ((q C + r) blockDim.x + t) N .. + N - 1, taken
// in the order of q (two trips' loads issued together). Each block
// reduces its share (the warps' trees, one barrier, warp 0's tree) and
// stores it into slot r of rank 0's shared memory; after one cluster
// barrier rank 0 joins the slots in rank order and writes the results.
template <typename T, bool FTS, bool VEC>
__global__ void __launch_bounds__(CLUSTER_THREADS)
    r_step(const T* __restrict__ v, const T* __restrict__ s,
           const T* __restrict__ dv, const T* __restrict__ ds, double scale,
           T* __restrict__ alpha, bool* __restrict__ ok, T* __restrict__ dots,
           T* __restrict__ fts, int B, int m, long long sv, long long ss,
           long long sdv, long long sds) {
  namespace cg = cooperative_groups;
  constexpr int N = Lanes<T>::N;
  __shared__ StepPart<T> warps[CLUSTER_WARPS];
  __shared__ StepPart<T> slots[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T sc = static_cast<T>(scale);
  const long long first =
      (static_cast<long long>(rank) * blockDim.x + threadIdx.x) * N;
  const long long span = static_cast<long long>(C) * blockDim.x * N;
  StepPart<T>* slot = cluster.map_shared_rank(&slots[rank], 0);
  const auto barrier = [&cluster, C] {
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T *vb = v + b * sv, *sb = s + b * ss;
    const T *dvb = dv + b * sdv, *dsb = ds + b * sds;
    StepAcc<T, FTS> acc;
    for (long long i = first; i < m; i += 2 * span) {
      const long long j = i + span;
      const int n0 = static_cast<int>(m - i < N ? m - i : N);
      const int n1 = j < m ? static_cast<int>(m - j < N ? m - j : N) : 0;
      T v0[N], s0[N], dv0[N], ds0[N], v1[N], s1[N], dv1[N], ds1[N];
      // both trips' loads first: one wait for device memory
      load<T, VEC>(v0, vb, i, n0);
      load<T, VEC>(s0, sb, i, n0);
      load<T, VEC>(dv0, dvb, i, n0);
      load<T, VEC>(ds0, dsb, i, n0);
      load<T, VEC>(v1, vb, j, n1);
      load<T, VEC>(s1, sb, j, n1);
      load<T, VEC>(dv1, dvb, j, n1);
      load<T, VEC>(ds1, dsb, j, n1);
      acc.take(v0, s0, dv0, ds0, n0, sc);
      acc.take(v1, s1, dv1, ds1, n1, sc);
    }
    // the warps' trees, then one pass through shared memory
    acc.fin = __all_sync(0xffffffffu, acc.fin);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc.fold(o);
    if (lane == 0) acc.put(&warps[warp]);
    __syncthreads();
    if (warp == 0) {
      StepAcc<T, FTS> w;
      if (lane < CLUSTER_WARPS) w.get(warps[lane]);
      w.fin = __all_sync(0xffffffffu, w.fin);
#pragma unroll
      for (int o = CLUSTER_WARPS / 2; o > 0; o >>= 1) w.fold(o);
      if (lane == 0) w.put(slot);  // into rank 0's shared memory
    }
    // the slots' stores are seen by rank 0 after the barrier (a cluster
    // of one block needs only the block's)
    barrier();
    if (rank == 0 && threadIdx.x == 0) {
      StepAcc<T, FTS> all;
      all.get(slots[0]);
      for (unsigned r = 1; r < C; ++r) all.join(slots[r]);
      const T a = nan_min(nan_min(all.av, T(1)), nan_min(all.as, T(1)));
      alpha[b] = a;
      ok[b] = all.fin != 0;
      if (FTS) {
        const T D0 = static_cast<T>(all.d0), D1 = static_cast<T>(all.d1);
        const T D2 = static_cast<T>(all.d2), D3 = static_cast<T>(all.d3);
        T* d = dots + 4 * b;
        d[0] = D0;
        d[1] = D1;
        d[2] = D2;
        d[3] = D3;
        fts[b] = add(sub(sub(D0, mul(a, D1)), mul(a, D2)), mul(mul(a, a), D3));
      }
    }
    // the next instance's stores wait until rank 0 has read these
    if (b + gridDim.y < B) barrier();
  }
}

// Nothing: launched with an entry's plan, its time is the fixed cost of a
// node of that shape (chip_smoke.py's launch_floor_ms).
__global__ void r_empty(int) {}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

// The launch's own error, else the runtime's last one (which this also
// clears, so that no later check of PyTorch's finds it).
inline int launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// A launch of `grid` blocks of `threads` in clusters of `cluster` blocks
// along x (0: an ordinary launch, no cluster).
struct Launch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  Launch(dim3 grid, int threads, int cluster, void* stream) {
    config.gridDim = grid;
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = 0;
    config.stream = as_stream(stream);
    if (cluster > 0) {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
    }
  }
};

template <typename T>
int scaling(const T* v, const T* s, T* r_d, T* rinv, T* lam, T* lam2,
            T* mubar, int B, int m, long long sv, long long ss, int vec,
            int cluster, int grid_y, int threads, void* stream) {
  if (cluster < 1) return cudaErrorInvalidValue;
  const Launch l(dim3(cluster, grid_y), threads, cluster, stream);
  if (vec)
    return launched(cudaLaunchKernelEx(&l.config, r_scaling<T, true>, v, s,
                                       r_d, rinv, lam, lam2, mubar, B, m, sv,
                                       ss));
  return launched(cudaLaunchKernelEx(&l.config, r_scaling<T, false>, v, s,
                                     r_d, rinv, lam, lam2, mubar, B, m, sv,
                                     ss));
}

template <typename T, bool POST>
int reduce4_plan(int vec, dim3 grid, int threads, cudaStream_t st,
                 const T* x, const T* lam, const T* r_d, const T* y, T* out,
                 T* out2, int B, int m, long long sx, long long sl,
                 long long sr, long long sy) {
  if (vec)
    r_reduce4<T, POST, true><<<grid, threads, 0, st>>>(
        x, lam, r_d, y, out, out2, B, m, sx, sl, sr, sy);
  else
    r_reduce4<T, POST, false><<<grid, threads, 0, st>>>(
        x, lam, r_d, y, out, out2, B, m, sx, sl, sr, sy);
  return launched(cudaSuccess);
}

template <typename T>
int reduce4(int post, const T* x, const T* lam, const T* r_d, const T* y,
            T* out, T* out2, int B, int m, long long sx, long long sl,
            long long sr, long long sy, int vec, int grid_x, int grid_y,
            int threads, void* stream) {
  const dim3 grid(grid_x, grid_y);
  if (post)
    return reduce4_plan<T, true>(vec, grid, threads, as_stream(stream), x,
                                 lam, r_d, y, out, out2, B, m, sx, sl, sr,
                                 sy);
  return reduce4_plan<T, false>(vec, grid, threads, as_stream(stream), x,
                                lam, r_d, y, out, out2, B, m, sx, sl, sr, sy);
}

template <typename T, int MODE>
int comp_plan(int vec, dim3 grid, int threads, cudaStream_t st, const T* a,
              const T* r_d, const T* rinv, const T* dv, const T* ds,
              const T* smu, const T* atil, T* out, int B, int m, long long sa,
              long long sr, long long si, long long sdv, long long sds) {
  if (vec)
    r_comp<T, MODE, true><<<grid, threads, 0, st>>>(
        a, r_d, rinv, dv, ds, smu, atil, out, B, m, sa, sr, si, sdv, sds);
  else
    r_comp<T, MODE, false><<<grid, threads, 0, st>>>(
        a, r_d, rinv, dv, ds, smu, atil, out, B, m, sa, sr, si, sdv, sds);
  return launched(cudaSuccess);
}

template <typename T>
int comp(int mode, const T* a, const T* r_d, const T* rinv, const T* dv,
         const T* ds, const T* smu, const T* atil, T* out, int B, int m,
         long long sa, long long sr, long long si, long long sdv,
         long long sds, int vec, int grid_x, int grid_y, int threads,
         void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = as_stream(stream);
  switch (mode) {
    case CORRECTOR:
      return comp_plan<T, CORRECTOR>(vec, grid, threads, st, a, r_d, rinv, dv,
                                     ds, smu, atil, out, B, m, sa, sr, si,
                                     sdv, sds);
    case K4:
      return comp_plan<T, K4>(vec, grid, threads, st, a, r_d, rinv, dv, ds,
                              smu, atil, out, B, m, sa, sr, si, sdv, sds);
    case GONDZIO:
      return comp_plan<T, GONDZIO>(vec, grid, threads, st, a, r_d, rinv, dv,
                                   ds, smu, atil, out, B, m, sa, sr, si, sdv,
                                   sds);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool FTS>
int step_plan(int vec, const Launch& l, const T* v, const T* s, const T* dv,
              const T* ds, double scale, T* alpha, bool* ok, T* dots, T* fts,
              int B, int m, long long sv, long long ss, long long sdv,
              long long sds) {
  if (vec)
    return launched(cudaLaunchKernelEx(&l.config, r_step<T, FTS, true>, v, s,
                                       dv, ds, scale, alpha, ok, dots, fts, B,
                                       m, sv, ss, sdv, sds));
  return launched(cudaLaunchKernelEx(&l.config, r_step<T, FTS, false>, v, s,
                                     dv, ds, scale, alpha, ok, dots, fts, B,
                                     m, sv, ss, sdv, sds));
}

template <typename T>
int step(int with_fts, const T* v, const T* s, const T* dv, const T* ds,
         double scale, T* alpha, bool* ok, T* dots, T* fts, int B, int m,
         long long sv, long long ss, long long sdv, long long sds, int vec,
         int cluster, int grid_y, int threads, void* stream) {
  if (cluster < 1) return cudaErrorInvalidValue;
  const Launch l(dim3(cluster, grid_y), threads, cluster, stream);
  if (with_fts)
    return step_plan<T, true>(vec, l, v, s, dv, ds, scale, alpha, ok, dots,
                              fts, B, m, sv, ss, sdv, sds);
  return step_plan<T, false>(vec, l, v, s, dv, ds, scale, alpha, ok, dots,
                             fts, B, m, sv, ss, sdv, sds);
}

template <typename T>
cudaError_t preload() {
  // load every instance's code now (CUDA loads a kernel lazily, at its
  // first launch), so that no first launch falls inside a graph capture
  const void* fns[] = {
      reinterpret_cast<const void*>(&r_scaling<T, false>),
      reinterpret_cast<const void*>(&r_scaling<T, true>),
      reinterpret_cast<const void*>(&r_reduce4<T, false, false>),
      reinterpret_cast<const void*>(&r_reduce4<T, false, true>),
      reinterpret_cast<const void*>(&r_reduce4<T, true, false>),
      reinterpret_cast<const void*>(&r_reduce4<T, true, true>),
      reinterpret_cast<const void*>(&r_comp<T, CORRECTOR, false>),
      reinterpret_cast<const void*>(&r_comp<T, CORRECTOR, true>),
      reinterpret_cast<const void*>(&r_comp<T, K4, false>),
      reinterpret_cast<const void*>(&r_comp<T, K4, true>),
      reinterpret_cast<const void*>(&r_comp<T, GONDZIO, false>),
      reinterpret_cast<const void*>(&r_comp<T, GONDZIO, true>),
      reinterpret_cast<const void*>(&r_step<T, false, false>),
      reinterpret_cast<const void*>(&r_step<T, false, true>),
      reinterpret_cast<const void*>(&r_step<T, true, false>),
      reinterpret_cast<const void*>(&r_step<T, true, true>)};
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int conicip_rcone_preload() {
  cudaError_t err = preload<double>();
  if (err == cudaSuccess) err = preload<float>();
  if (err == cudaSuccess) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(&r_empty));
  }
  return err;
}

int conicip_rcone_empty(int grid_x, int grid_y, int threads, int cluster,
                        void* stream) {
  const Launch l(dim3(grid_x, grid_y), threads, cluster, stream);
  return launched(cudaLaunchKernelEx(&l.config, r_empty, 0));
}

int conicip_r_scaling_f64(const double* v, const double* s, double* r_d,
                          double* rinv, double* lam, double* lam2,
                          double* mubar, int B, int m, long long sv,
                          long long ss, int vec, int cluster, int grid_y,
                          int threads, void* stream) {
  return scaling(v, s, r_d, rinv, lam, lam2, mubar, B, m, sv, ss, vec,
                 cluster, grid_y, threads, stream);
}
int conicip_r_scaling_f32(const float* v, const float* s, float* r_d,
                          float* rinv, float* lam, float* lam2, float* mubar,
                          int B, int m, long long sv, long long ss, int vec,
                          int cluster, int grid_y, int threads,
                          void* stream) {
  return scaling(v, s, r_d, rinv, lam, lam2, mubar, B, m, sv, ss, vec,
                 cluster, grid_y, threads, stream);
}

int conicip_r_reduce4_f64(int post, const double* x, const double* lam,
                          const double* r_d, const double* y, double* out,
                          double* out2, int B, int m, long long sx,
                          long long sl, long long sr, long long sy, int vec,
                          int grid_x, int grid_y, int threads, void* stream) {
  return reduce4(post, x, lam, r_d, y, out, out2, B, m, sx, sl, sr, sy, vec,
                 grid_x, grid_y, threads, stream);
}
int conicip_r_reduce4_f32(int post, const float* x, const float* lam,
                          const float* r_d, const float* y, float* out,
                          float* out2, int B, int m, long long sx,
                          long long sl, long long sr, long long sy, int vec,
                          int grid_x, int grid_y, int threads, void* stream) {
  return reduce4(post, x, lam, r_d, y, out, out2, B, m, sx, sl, sr, sy, vec,
                 grid_x, grid_y, threads, stream);
}

int conicip_r_comp_f64(int mode, const double* a, const double* r_d,
                       const double* rinv, const double* dv, const double* ds,
                       const double* smu, const double* atil, double* out,
                       int B, int m, long long sa, long long sr, long long si,
                       long long sdv, long long sds, int vec, int grid_x,
                       int grid_y, int threads, void* stream) {
  return comp(mode, a, r_d, rinv, dv, ds, smu, atil, out, B, m, sa, sr, si,
              sdv, sds, vec, grid_x, grid_y, threads, stream);
}
int conicip_r_comp_f32(int mode, const float* a, const float* r_d,
                       const float* rinv, const float* dv, const float* ds,
                       const float* smu, const float* atil, float* out, int B,
                       int m, long long sa, long long sr, long long si,
                       long long sdv, long long sds, int vec, int grid_x,
                       int grid_y, int threads, void* stream) {
  return comp(mode, a, r_d, rinv, dv, ds, smu, atil, out, B, m, sa, sr, si,
              sdv, sds, vec, grid_x, grid_y, threads, stream);
}

int conicip_r_step_f64(int with_fts, const double* v, const double* s,
                       const double* dv, const double* ds, double scale,
                       double* alpha, bool* ok, double* dots, double* fts,
                       int B, int m, long long sv, long long ss,
                       long long sdv, long long sds, int vec, int cluster,
                       int grid_y, int threads, void* stream) {
  return step(with_fts, v, s, dv, ds, scale, alpha, ok, dots, fts, B, m, sv,
              ss, sdv, sds, vec, cluster, grid_y, threads, stream);
}
int conicip_r_step_f32(int with_fts, const float* v, const float* s,
                       const float* dv, const float* ds, double scale,
                       float* alpha, bool* ok, float* dots, float* fts, int B,
                       int m, long long sv, long long ss, long long sdv,
                       long long sds, int vec, int cluster, int grid_y,
                       int threads, void* stream) {
  return step(with_fts, v, s, dv, ds, scale, alpha, ok, dots, fts, B, m, sv,
              ss, sdv, sds, vec, cluster, grid_y, threads, stream);
}

}  // extern "C"
