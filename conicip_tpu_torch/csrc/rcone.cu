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
// a launch costs more than that, and the yardstick is the launch sequence
// replaced. Design: one thread block per instance (grid = B), a
// block-stride loop over m, per-instance reductions by warp shuffles and
// shared memory in a fixed tree and no atomics, so a result is the same
// bits at every launch (the device loop is held bit for bit against the
// eager loop). Elementwise arithmetic is the correctly rounded intrinsics,
// which the compiler may not contract into an FMA, so every elementwise
// output is the bits of the plain sequence, which rounds each operation on
// its own; only the reduced values (mubar, the dots, fts) differ from the
// plain twin's, in summation order (sums accumulate in double for both
// dtypes). max/min/clamp propagate NaN as PyTorch's CUDA kernels do.
//
// C interface, loaded with ctypes by ops/rcone_kernel.py: every pointer a
// contiguous (B, m) vector or a (B,) per-instance value on the current
// device, launched on `stream`, not synchronised; each returns
// cudaGetLastError() after its one launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

struct Sum {
  __device__ __forceinline__ double operator()(double a, double b) const {
    return a + b;
  }
};
struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return nan_min(a, b);
  }
};

// The block's reduction of one value per thread, valid in thread 0: a
// shuffle tree in each warp, then one over the warps' results in
// `shared` (WARPS slots, one array per reduction of a kernel). The order
// is fixed, so the result is the same bits at every launch.
template <typename R, typename Op>
__device__ __forceinline__ R block_reduce(R v, Op op, R* shared) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = shared[lane & (WARPS - 1)];
    for (int o = WARPS / 2; o > 0; o >>= 1)
      v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    r_scaling(const T* __restrict__ v, const T* __restrict__ s,
              T* __restrict__ r_d, T* __restrict__ rinv, T* __restrict__ lam,
              T* __restrict__ lam2, T* __restrict__ mubar, int m) {
  __shared__ double part[WARPS];
  const long long row = static_cast<long long>(blockIdx.x) * m;
  double acc = 0.0;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const long long k = row + i;
    const T vi = v[k], si = s[k];
    const T r = root(quo(si, vi));
    const T l = mul(r, vi);
    r_d[k] = r;
    rinv[k] = quo(T(1), r);
    lam[k] = l;
    lam2[k] = mul(l, l);
    acc += static_cast<double>(mul(vi, si));
  }
  acc = block_reduce(acc, Sum(), part);
  if (threadIdx.x == 0) mubar[blockIdx.x] = static_cast<T>(acc);
}

// POST false: x = r.s, y = r.v; out = t1 = r_d (x / lam), out2 = y + t1.
// POST true:  x = t1,  y = dv;  out = ds = t1 - r_d (r_d dv).
template <typename T, bool POST>
__global__ void __launch_bounds__(THREADS)
    r_reduce4(const T* __restrict__ x, const T* __restrict__ lam,
              const T* __restrict__ r_d, const T* __restrict__ y,
              T* __restrict__ out, T* __restrict__ out2, int m) {
  const long long row = static_cast<long long>(blockIdx.x) * m;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const long long k = row + i;
    const T r = r_d[k];
    if (POST) {
      out[k] = sub(x[k], mul(r, mul(r, y[k])));
    } else {
      const T t1 = mul(r, quo(x[k], lam[k]));
      out[k] = t1;
      out2[k] = add(y[k], t1);
    }
  }
}

enum Comp { CORRECTOR = 0, K4 = 1, GONDZIO = 2 };

// F dv = r_d dv and F^-T ds = rinv ds, then by MODE:
//   CORRECTOR  out = x - (-(F^-T ds)(F dv) + smu), x = rleft.s
//   K4         out = lam (F dv) + lam (F^-T ds)
//   GONDZIO    w = (lam - atil F dv)(lam - atil F^-T ds), lo = 0.1 smu,
//              hi = 10 smu, out = -max(min(max(w, lo), hi) - w, -hi)
// smu (sigma mu) and atil are per instance.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
    r_comp(const T* __restrict__ lam, const T* __restrict__ r_d,
           const T* __restrict__ rinv, const T* __restrict__ dv,
           const T* __restrict__ ds, const T* __restrict__ x,
           const T* __restrict__ smu, const T* __restrict__ atil,
           T* __restrict__ out, int m) {
  const long long row = static_cast<long long>(blockIdx.x) * m;
  T sm = T(0), at = T(0);
  if (MODE != K4) sm = smu[blockIdx.x];
  if (MODE == GONDZIO) at = atil[blockIdx.x];
  const T lo = mul(sm, T(0.1)), hi = mul(sm, T(10.0));
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const long long k = row + i;
    const T fdv = mul(r_d[k], dv[k]);
    const T fds = mul(rinv[k], ds[k]);
    if (MODE == CORRECTOR) {
      out[k] = sub(x[k], add(-mul(fds, fdv), sm));
    } else if (MODE == K4) {
      const T l = lam[k];
      out[k] = add(mul(l, fdv), mul(l, fds));
    } else {
      const T l = lam[k];
      const T w = mul(sub(l, mul(at, fdv)), sub(l, mul(at, fds)));
      out[k] = -nan_max(sub(nan_min(nan_max(w, lo), hi), w), -hi);
    }
  }
}

// alpha = min(clamp(min_{dv' > 0} v / dv', max=1), clamp(min_{ds' > 0}
// s / ds', max=1)) over dv' = dv scale, ds' = ds scale (each rounded
// before the division, as the plain sequence rounds it), ok = every
// entry of dv and ds finite; with FTS also dots = (v.s, v.ds, dv.s,
// dv.ds) and fts = ((v.s - alpha v.ds) - alpha dv.s) + alpha^2 dv.ds.
template <typename T, bool FTS>
__global__ void __launch_bounds__(THREADS)
    r_step(const T* __restrict__ v, const T* __restrict__ s,
           const T* __restrict__ dv, const T* __restrict__ ds, double scale,
           T* __restrict__ alpha, bool* __restrict__ ok, T* __restrict__ dots,
           T* __restrict__ fts, int m) {
  __shared__ T least[2][WARPS];
  __shared__ double part[4][WARPS];
  const long long row = static_cast<long long>(blockIdx.x) * m;
  const T sc = static_cast<T>(scale);
  T av = inf<T>(), as = inf<T>();
  int fin = 1;
  double d0 = 0.0, d1 = 0.0, d2 = 0.0, d3 = 0.0;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const long long k = row + i;
    const T vi = v[k], si = s[k], dvi = dv[k], dsi = ds[k];
    fin &= finite(dvi) && finite(dsi);
    const T a = mul(dvi, sc), b = mul(dsi, sc);
    av = nan_min(av, a > T(0) ? quo(vi, a) : inf<T>());
    as = nan_min(as, b > T(0) ? quo(si, b) : inf<T>());
    if (FTS) {
      d0 += static_cast<double>(mul(vi, si));
      d1 += static_cast<double>(mul(vi, dsi));
      d2 += static_cast<double>(mul(dvi, si));
      d3 += static_cast<double>(mul(dvi, dsi));
    }
  }
  fin = __syncthreads_and(fin);
  av = block_reduce(av, Min(), least[0]);
  as = block_reduce(as, Min(), least[1]);
  if (FTS) {
    d0 = block_reduce(d0, Sum(), part[0]);
    d1 = block_reduce(d1, Sum(), part[1]);
    d2 = block_reduce(d2, Sum(), part[2]);
    d3 = block_reduce(d3, Sum(), part[3]);
  }
  if (threadIdx.x == 0) {
    const T a = nan_min(nan_min(av, T(1)), nan_min(as, T(1)));
    alpha[blockIdx.x] = a;
    ok[blockIdx.x] = fin != 0;
    if (FTS) {
      const T D0 = static_cast<T>(d0), D1 = static_cast<T>(d1);
      const T D2 = static_cast<T>(d2), D3 = static_cast<T>(d3);
      T* d = dots + 4LL * blockIdx.x;
      d[0] = D0;
      d[1] = D1;
      d[2] = D2;
      d[3] = D3;
      fts[blockIdx.x] =
          add(sub(sub(D0, mul(a, D1)), mul(a, D2)), mul(mul(a, a), D3));
    }
  }
}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <typename T>
int scaling(const T* v, const T* s, T* r_d, T* rinv, T* lam, T* lam2,
            T* mubar, int B, int m, void* stream) {
  r_scaling<T><<<B, THREADS, 0, as_stream(stream)>>>(v, s, r_d, rinv, lam,
                                                     lam2, mubar, m);
  return cudaGetLastError();
}

template <typename T>
int reduce4(int post, const T* x, const T* lam, const T* r_d, const T* y,
            T* out, T* out2, int B, int m, void* stream) {
  if (post)
    r_reduce4<T, true><<<B, THREADS, 0, as_stream(stream)>>>(x, lam, r_d, y,
                                                             out, out2, m);
  else
    r_reduce4<T, false><<<B, THREADS, 0, as_stream(stream)>>>(x, lam, r_d, y,
                                                              out, out2, m);
  return cudaGetLastError();
}

template <typename T>
int comp(int mode, const T* lam, const T* r_d, const T* rinv, const T* dv,
         const T* ds, const T* x, const T* smu, const T* atil, T* out, int B,
         int m, void* stream) {
  cudaStream_t st = as_stream(stream);
  switch (mode) {
    case CORRECTOR:
      r_comp<T, CORRECTOR><<<B, THREADS, 0, st>>>(lam, r_d, rinv, dv, ds, x,
                                                  smu, atil, out, m);
      break;
    case K4:
      r_comp<T, K4><<<B, THREADS, 0, st>>>(lam, r_d, rinv, dv, ds, x, smu,
                                           atil, out, m);
      break;
    case GONDZIO:
      r_comp<T, GONDZIO><<<B, THREADS, 0, st>>>(lam, r_d, rinv, dv, ds, x,
                                                smu, atil, out, m);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int step(int with_fts, const T* v, const T* s, const T* dv, const T* ds,
         double scale, T* alpha, bool* ok, T* dots, T* fts, int B, int m,
         void* stream) {
  if (with_fts)
    r_step<T, true><<<B, THREADS, 0, as_stream(stream)>>>(
        v, s, dv, ds, scale, alpha, ok, dots, fts, m);
  else
    r_step<T, false><<<B, THREADS, 0, as_stream(stream)>>>(
        v, s, dv, ds, scale, alpha, ok, dots, fts, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t preload() {
  // load every instance's code now (CUDA loads a kernel lazily, at its
  // first launch), so that no first launch falls inside a graph capture
  const void* fns[] = {
      reinterpret_cast<const void*>(&r_scaling<T>),
      reinterpret_cast<const void*>(&r_reduce4<T, false>),
      reinterpret_cast<const void*>(&r_reduce4<T, true>),
      reinterpret_cast<const void*>(&r_comp<T, CORRECTOR>),
      reinterpret_cast<const void*>(&r_comp<T, K4>),
      reinterpret_cast<const void*>(&r_comp<T, GONDZIO>),
      reinterpret_cast<const void*>(&r_step<T, false>),
      reinterpret_cast<const void*>(&r_step<T, true>)};
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
  const cudaError_t err = preload<double>();
  return err != cudaSuccess ? err : preload<float>();
}

int conicip_r_scaling_f64(const double* v, const double* s, double* r_d,
                          double* rinv, double* lam, double* lam2,
                          double* mubar, int B, int m, void* stream) {
  return scaling(v, s, r_d, rinv, lam, lam2, mubar, B, m, stream);
}
int conicip_r_scaling_f32(const float* v, const float* s, float* r_d,
                          float* rinv, float* lam, float* lam2, float* mubar,
                          int B, int m, void* stream) {
  return scaling(v, s, r_d, rinv, lam, lam2, mubar, B, m, stream);
}

int conicip_r_reduce4_f64(int post, const double* x, const double* lam,
                          const double* r_d, const double* y, double* out,
                          double* out2, int B, int m, void* stream) {
  return reduce4(post, x, lam, r_d, y, out, out2, B, m, stream);
}
int conicip_r_reduce4_f32(int post, const float* x, const float* lam,
                          const float* r_d, const float* y, float* out,
                          float* out2, int B, int m, void* stream) {
  return reduce4(post, x, lam, r_d, y, out, out2, B, m, stream);
}

int conicip_r_comp_f64(int mode, const double* lam, const double* r_d,
                       const double* rinv, const double* dv, const double* ds,
                       const double* x, const double* smu, const double* atil,
                       double* out, int B, int m, void* stream) {
  return comp(mode, lam, r_d, rinv, dv, ds, x, smu, atil, out, B, m, stream);
}
int conicip_r_comp_f32(int mode, const float* lam, const float* r_d,
                       const float* rinv, const float* dv, const float* ds,
                       const float* x, const float* smu, const float* atil,
                       float* out, int B, int m, void* stream) {
  return comp(mode, lam, r_d, rinv, dv, ds, x, smu, atil, out, B, m, stream);
}

int conicip_r_step_f64(int with_fts, const double* v, const double* s,
                       const double* dv, const double* ds, double scale,
                       double* alpha, bool* ok, double* dots, double* fts,
                       int B, int m, void* stream) {
  return step(with_fts, v, s, dv, ds, scale, alpha, ok, dots, fts, B, m,
              stream);
}
int conicip_r_step_f32(int with_fts, const float* v, const float* s,
                       const float* dv, const float* ds, double scale,
                       float* alpha, bool* ok, float* dots, float* fts, int B,
                       int m, void* stream) {
  return step(with_fts, v, s, dv, ds, scale, alpha, ok, dots, fts, B, m,
              stream);
}

}  // extern "C"
