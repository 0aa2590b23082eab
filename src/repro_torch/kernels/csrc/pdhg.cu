// Restarted PDHG, one thread block per LP, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pdhg_pallas.py:_kernel (the Pallas TPU kernel
// that runs src/repro/core/pdhg.py:pdhg_step over a VMEM tile of LPs until
// every LP has left RUNNING or the cap is reached).
//
// The function, per LP and step, in pdhg_step's order: aty = A'y; the relative
// KKT residuals pres = ||relu(ax - b)|| / bscale, dres = ||relu(c - aty)|| /
// cscale and the gap |c.x - b.y| / (1 + |c.x| + |b.y|) against tol; at restart
// boundaries, the growth-gated divergence certificates (a dual Farkas ray:
// INFEASIBLE; a primal improving ray with a small residual: UNBOUNDED); then,
// while the LP still runs, x1 = relu(x + tau (c - aty)), ax1 = A x1,
// y1 = relu(y + sigma (2 ax1 - ax - b)), and the restart bookkeeping (running
// sums, and every `restart` steps the iterate reset to their average).  A
// finished LP is frozen in the reference's lockstep loop, so each block loops
// on its own LP until it stops or reaches the cap: the same per-LP steps,
// status and state.  The objective is computed by the wrapper after the launch.
//
// What bounds it on this card: each step reads A twice (A'y and A x1), 4 m n
// flops.  At 500 x 500 in float32 A is 1 MB per LP, and a batch of 256 LPs
// (256 MB) is about five times the L2, so this kernel streams A from HBM every
// step: 2 m n * itemsize bytes per step.  Keeping A on chip (a thread-block
// cluster's distributed shared memory could hold 1 MB) would make it bound by
// arithmetic instead; that is later work.
//
// The design (simple and right first):
//  * one CTA of 512 threads per LP (blockIdx.x = LP row); 512 threads so that
//    two blocks per SM keep enough loads of A in flight;
//  * the state (x, y, ax, the running sums, inner, the growth norms) is updated
//    in place in the caller's buffers, so a resume and a want_state solve are
//    the same launch; aty, and then x1, live in a per-LP scratch vector;
//  * A is read through the read-only path, both matvec loops unrolled by 16
//    so that a block alone on its SM (the LPs that run longest) keeps
//    sixteen loads of A in flight a thread: a step is latency-bound there;
//  * aty_j: one thread per column j, rows i ascending (coalesced across the
//    warp).  The same thread then folds column j into the per-thread partials
//    of dres, c.x, ||x|| and max relu(-aty), and rows tid, tid + 512, ... into
//    those of pres, b.y, ||y|| and max relu(ax);
//  * the eight partials are reduced by a fixed tree (warp shuffles, then the
//    warps in order), and thread 0 takes the status decision, which the block
//    reads back through shared memory;
//  * ax1_i: one warp per row i, lane l summing columns l, l + 32, ... in
//    ascending order, then a fixed shuffle tree; lane 0 finishes row i (y1,
//    the sums, the restart) in place.
//
// Determinism: no atomics and fixed reduction orders, so the kernel is
// deterministic run to run, and a chain of launches whose caps sum to K is
// bit-identical to one launch at cap K.  It is not bit-identical to the plain
// version (core/pdhg.py), whose matvecs are library products with their own
// reduction order.  Every multiply, add, subtract and divide is a separately
// rounded IEEE operation (the library is built -fmad=false, without fast
// math); the constants are rounded to the data's type and applied in the
// reference's order (growth = (T)(GROWTH_FRACTION * restart), then * step,
// * CERT_EPS, * scale); relu and max propagate NaN as torch.clamp_min and
// torch.amax do.

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int PDHG_THREADS = 512;
constexpr int PDHG_WARPS = PDHG_THREADS / 32;

template <typename T>
__device__ __forceinline__ T relu(T v) {
  return (v > T(0) || v != v) ? v : T(0);
}

// max(a, b) that returns NaN when either is NaN.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

constexpr int NSUM = 6;  // pres, dres, pobj, dobj, ||x||^2, ||y||^2
constexpr int NMAX = 2;  // max relu(-aty), max relu(ax)

template <typename T>
__device__ __forceinline__ void warp_reduce(T (&s)[NSUM], T (&mx)[NMAX]) {
  using AR = Arith<T>;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NSUM; ++k) s[k] = AR::add(s[k], __shfl_down_sync(0xffffffffu, s[k], off));
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      mx[k] = nan_max(mx[k], __shfl_down_sync(0xffffffffu, mx[k], off));
  }
}

template <typename T>
__global__ void __launch_bounds__(PDHG_THREADS)
pdhg_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
            T* __restrict__ x_io, T* __restrict__ y_io, T* __restrict__ ax_io,
            T* __restrict__ xs_io, T* __restrict__ ys_io, T* __restrict__ axs_io,
            int* __restrict__ inner_io, T* __restrict__ xg_io, T* __restrict__ yg_io,
            const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
            const T* __restrict__ anorm_in, const T* __restrict__ bscale_in,
            const T* __restrict__ cscale_in, T* __restrict__ scratch,
            int* __restrict__ status_out, int* __restrict__ iters_out, int m, int n, int cap,
            int restart, T tol, T growth) {
  using AR = Arith<T>;
  __shared__ T red_s[PDHG_WARPS][NSUM];
  __shared__ T red_m[PDHG_WARPS][NMAX];
  __shared__ int sh_status;
  __shared__ int sh_restart;
  __shared__ T sh_cnt;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long lp = blockIdx.x;
  const T* al = a + lp * (long long)m * n;
  const T* bl = b + lp * (long long)m;
  const T* cl = c + lp * (long long)n;
  T* x = x_io + lp * (long long)n;
  T* xs = xs_io + lp * (long long)n;
  T* y = y_io + lp * (long long)m;
  T* ax = ax_io + lp * (long long)m;
  T* ys = ys_io + lp * (long long)m;
  T* axs = axs_io + lp * (long long)m;
  T* v = scratch + lp * (long long)n;  // aty, then x1

  const T tau = tau_in[lp], sigma = sigma_in[lp];
  const T anorm = anorm_in[lp], bscale = bscale_in[lp], cscale = cscale_in[lp];
  const T tiny = static_cast<T>(1e-30);
  const T cert_eps = static_cast<T>(1e-3);
  const T guard = static_cast<T>(1e3);
  // Thread 0 owns the per-LP scalars of the loop.
  int inner = inner_io[lp];
  T xg = xg_io[lp], yg = yg_io[lp];
  int status = RUNNING;
  int iters = 0;

  for (int step = 0; step < cap; ++step) {
    // ---- aty = A'y (column per thread, rows ascending) and the partials.
    T s[NSUM] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T mx[NMAX] = {T(0), T(0)};
    for (int j = tid; j < n; j += PDHG_THREADS) {
      T acc = T(0);
#pragma unroll 16
      for (int i = 0; i < m; ++i)
        acc = AR::add(acc, AR::mul(__ldg(al + (long long)i * n + j), y[i]));
      v[j] = acc;
      const T cj = __ldg(cl + j), xj = x[j];
      const T d = relu(AR::sub(cj, acc));
      s[1] = AR::add(s[1], AR::mul(d, d));
      s[2] = AR::add(s[2], AR::mul(cj, xj));
      s[4] = AR::add(s[4], AR::mul(xj, xj));
      mx[0] = nan_max(mx[0], relu(-acc));
    }
    for (int i = tid; i < m; i += PDHG_THREADS) {
      const T bi = __ldg(bl + i), yi = y[i], axi = ax[i];
      const T r = relu(AR::sub(axi, bi));
      s[0] = AR::add(s[0], AR::mul(r, r));
      s[3] = AR::add(s[3], AR::mul(bi, yi));
      s[5] = AR::add(s[5], AR::mul(yi, yi));
      mx[1] = nan_max(mx[1], relu(axi));
    }
    warp_reduce(s, mx);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NSUM; ++k) red_s[warp][k] = s[k];
#pragma unroll
      for (int k = 0; k < NMAX; ++k) red_m[warp][k] = mx[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < NSUM; ++k) s[k] = lane < PDHG_WARPS ? red_s[lane][k] : T(0);
#pragma unroll
      for (int k = 0; k < NMAX; ++k) mx[k] = lane < PDHG_WARPS ? red_m[lane][k] : T(0);
      warp_reduce(s, mx);
      if (lane == 0) {
        // ---- the status decision, in pdhg_step's order.
        const T pres = AR::div(sqrt(s[0]), bscale);
        const T dres = AR::div(sqrt(s[1]), cscale);
        const T pobj = s[2], dobj = s[3];
        const T gap = AR::div(fabs(AR::sub(pobj, dobj)),
                              AR::add(AR::add(T(1), fabs(pobj)), fabs(dobj)));
        const bool opt = pres <= tol && dres <= tol && gap <= tol;
        const T xnorm = sqrt(s[4]), ynorm = sqrt(s[5]);
        const bool at_period = inner + 1 >= restart;
        const T ray_eps = AR::mul(cert_eps, nan_max(anorm, T(1)));
        const T dual_ray = AR::div(mx[0], nan_max(ynorm, tiny));
        const bool infeas =
            at_period && ynorm >= guard &&
            AR::sub(ynorm, yg) >= AR::mul(AR::mul(AR::mul(growth, sigma), cert_eps), bscale) &&
            dual_ray <= ray_eps &&
            AR::div(dobj, nan_max(ynorm, tiny)) <= AR::mul(-cert_eps, bscale);
        const T prim_ray = AR::div(mx[1], nan_max(xnorm, tiny));
        const bool unbounded =
            at_period && xnorm >= guard &&
            AR::sub(xnorm, xg) >= AR::mul(AR::mul(AR::mul(growth, tau), cert_eps), cscale) &&
            prim_ray <= ray_eps &&
            AR::div(pobj, nan_max(xnorm, tiny)) >= AR::mul(cert_eps, cscale) && pres <= cert_eps;
        if (opt) status = OPTIMAL;
        else if (infeas) status = INFEASIBLE;
        else if (unbounded) status = UNBOUNDED;
        int do_restart = 0;
        if (status == RUNNING) {
          ++iters;
          const int cnt = inner + 1;
          do_restart = cnt >= restart;
          sh_cnt = static_cast<T>(cnt);
          inner = do_restart ? 0 : cnt;
          if (do_restart) {
            xg = xnorm;
            yg = ynorm;
          }
        }
        sh_status = status;
        sh_restart = do_restart;
      }
    }
    __syncthreads();
    if (sh_status != RUNNING) break;  // frozen: nothing else changes
    const bool dr = sh_restart != 0;
    const T cnt = sh_cnt;

    // ---- x1 = relu(x + tau (c - aty)); the primal sums and restart.
    for (int j = tid; j < n; j += PDHG_THREADS) {
      const T x1 = relu(AR::add(x[j], AR::mul(tau, AR::sub(__ldg(cl + j), v[j]))));
      v[j] = x1;
      const T xs1 = AR::add(xs[j], x1);
      x[j] = dr ? AR::div(xs1, cnt) : x1;
      xs[j] = dr ? T(0) : xs1;
    }
    __syncthreads();

    // ---- ax1 = A x1 (warp per row), then y1 and the dual sums and restart.
    for (int i = warp; i < m; i += PDHG_WARPS) {
      const T* row = al + (long long)i * n;
      T acc = T(0);
#pragma unroll 16
      for (int j = lane; j < n; j += 32) acc = AR::add(acc, AR::mul(__ldg(row + j), v[j]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = AR::add(acc, __shfl_down_sync(0xffffffffu, acc, off));
      if (lane == 0) {
        const T ax1 = acc, axi = ax[i], yi = y[i];
        const T y1 = relu(AR::add(
            yi, AR::mul(sigma, AR::sub(AR::sub(AR::mul(T(2), ax1), axi), __ldg(bl + i)))));
        const T ys1 = AR::add(ys[i], y1);
        const T axs1 = AR::add(axs[i], ax1);
        y[i] = dr ? AR::div(ys1, cnt) : y1;
        ys[i] = dr ? T(0) : ys1;
        ax[i] = dr ? AR::div(axs1, cnt) : ax1;
        axs[i] = dr ? T(0) : axs1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    status_out[lp] = status == RUNNING ? ITER_LIMIT : status;
    iters_out[lp] = iters;
    inner_io[lp] = inner;
    xg_io[lp] = xg;
    yg_io[lp] = yg;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* x, void* y, void* ax, void* xs,
           void* ys, void* axs, void* inner, void* xg, void* yg, const void* tau,
           const void* sigma, const void* anorm, const void* bscale, const void* cscale,
           void* scratch, void* status, void* iters, int bsz, int m, int n, int cap, int restart,
           double tol, double growth, void* stream) {
  if (bsz <= 0) return 0;
  pdhg_kernel<T><<<bsz, PDHG_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)x, (T*)y, (T*)ax, (T*)xs, (T*)ys, (T*)axs,
      (int*)inner, (T*)xg, (T*)yg, (const T*)tau, (const T*)sigma, (const T*)anorm,
      (const T*)bscale, (const T*)cscale, (T*)scratch, (int*)status, (int*)iters, m, n, cap,
      restart, static_cast<T>(tol), static_cast<T>(growth));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define PDHG_ARGS                                                                            \
  const void *a, const void *b, const void *c, void *x, void *y, void *ax, void *xs, void *ys, \
      void *axs, void *inner, void *xg, void *yg, const void *tau, const void *sigma,          \
      const void *anorm, const void *bscale, const void *cscale, void *scratch, void *status,  \
      void *iters, int bsz, int m, int n, int cap, int restart, double tol, double growth,     \
      void *stream

int pdhg_f32(PDHG_ARGS) {
  return launch<float>(a, b, c, x, y, ax, xs, ys, axs, inner, xg, yg, tau, sigma, anorm, bscale,
                       cscale, scratch, status, iters, bsz, m, n, cap, restart, tol, growth,
                       stream);
}

int pdhg_f64(PDHG_ARGS) {
  return launch<double>(a, b, c, x, y, ax, xs, ys, axs, inner, xg, yg, tau, sigma, anorm, bscale,
                        cscale, scratch, status, iters, bsz, m, n, cap, restart, tol, growth,
                        stream);
}

const char* pdhg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
