// Restarted PDHG for Hopper (sm_90a), in two variants.
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
// finished LP is frozen in the reference's lockstep loop, so each LP loops on
// its own until it stops or reaches the cap: the same per-LP steps, status and
// state.  The objective is computed by the wrapper after the launch.
//
// What bounds it on this card: each step reads A twice (A'y and A x1), 4 m n
// flops.  The slowest LPs of a batch run the most steps (40,000 at the auto
// cap at 500 x 500), so the time is the latency of one LP's step on the
// critical path, not the bandwidth of the batch.
//
// The cluster variant (pdhg_cluster_kernel, the main paths): one LP is one
// thread-block cluster of k CTAs (kernels/cluster.py:plan_pdhg picks the least
// k whose shared memory holds A: 5 at 500 x 500 float32, A 1 MB).
//  * CTA r holds a contiguous slice of A's rows in shared memory, loaded once
//    per launch with cp.async, and owns those rows' y, ax, y_sum, ax_sum and
//    b, and a slice of the columns' x, x_sum and c; the state is read from the
//    caller's buffers at the start and written back at the end, so a resume
//    and a want_state solve are the same launch;
//  * a step: each CTA forms the partial A'y of its rows for all n columns in
//    its own shared memory (rows ascending; two columns a thread, so that
//    each y_i read from shared memory serves two sums); after a
//    cluster barrier the owner of column slice s sums the k partials in rank
//    order 0..k-1 over DSMEM and computes the column-side partials (dres,
//    c.x, ||x||^2, max relu(-aty)) and x1 = relu(x + tau (c - aty)), which
//    does not depend on the step's decision; each CTA computes the row-side
//    partials (pres, b.y, ||y||^2, max relu(ax)); after a second barrier
//    every CTA reads the k x 8 partials and reduces them in rank order, so
//    every CTA takes the same status and restart decision without a
//    broadcast, and gathers the whole x1 over DSMEM; while thread 0 takes
//    the decision, the warps compute A x1 of the CTA's rows (four rows a
//    warp, so that each x1_j read serves four sums); if the LP runs on, the
//    owner folds x1 into its columns' sums and each CTA updates y and the
//    dual sums of its rows.  Two cluster barriers a step (block barriers
//    when k = 1); no atomics.  What is left of a step at 500 x 500 is mostly
//    those barriers, the DSMEM round trips and the block reductions
//    (PERF.md, section 6).
//
// The streaming variant (pdhg_kernel, an A past the largest cluster): one CTA
// of 512 threads per LP, A read from device memory twice a step through the
// read-only path (loads unrolled by 16), the state updated in place, aty and
// then x1 in a per-LP scratch vector; a thread per column for A'y, a warp per
// row for A x1, the eight partials reduced by a fixed tree and the status
// taken by thread 0.
//
// Determinism: no atomics and fixed reduction orders, so each variant is
// deterministic run to run, and a chain of launches whose caps sum to K is
// bit-identical to one launch at cap K (at the same k).  Neither is
// bit-identical to the plain version (core/pdhg.py), whose matvecs are library
// products with their own reduction order, nor to each other, nor across k
// (the cross-CTA sum of A'y changes the order).  Every multiply, add, subtract
// and divide is a separately rounded IEEE operation (the library is built
// -fmad=false, without fast math); the constants are rounded to the data's
// type and applied in the reference's order (growth = (T)(GROWTH_FRACTION *
// restart), then * step, * CERT_EPS, * scale); relu and max propagate NaN as
// torch.clamp_min and torch.amax do.

#include "cluster.cuh"
#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int PDHG_THREADS = 512;
constexpr int PDHG_WARPS = PDHG_THREADS / 32;
constexpr int HALF = PDHG_THREADS / 2;

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

// The status and restart decision of one step from the eight reduced
// partials s = (pres^2, dres^2, c.x, b.y, ||x||^2, ||y||^2), mx = (max
// relu(-aty), max relu(ax)), in pdhg_step's order.  Updates the per-LP
// scalars (status, iters, inner, the growth norms) and returns whether the
// step restarts, with the running count in cnt.
template <typename T>
__device__ __forceinline__ bool decide(const T (&s)[NSUM], const T (&mx)[NMAX], T tau, T sigma,
                                       T anorm, T bscale, T cscale, T tol, T growth,
                                       int restart, int& status, int& iters, int& inner, T& xg,
                                       T& yg, T& cnt) {
  using AR = Arith<T>;
  const T tiny = static_cast<T>(1e-30);
  const T cert_eps = static_cast<T>(1e-3);
  const T guard = static_cast<T>(1e3);
  const T pres = AR::div(sqrt(s[0]), bscale);
  const T dres = AR::div(sqrt(s[1]), cscale);
  const T pobj = s[2], dobj = s[3];
  const T gap = AR::div(fabs(AR::sub(pobj, dobj)), AR::add(AR::add(T(1), fabs(pobj)), fabs(dobj)));
  const bool opt = pres <= tol && dres <= tol && gap <= tol;
  const T xnorm = sqrt(s[4]), ynorm = sqrt(s[5]);
  const bool at_period = inner + 1 >= restart;
  const T ray_eps = AR::mul(cert_eps, nan_max(anorm, T(1)));
  const T dual_ray = AR::div(mx[0], nan_max(ynorm, tiny));
  const bool infeas =
      at_period && ynorm >= guard &&
      AR::sub(ynorm, yg) >= AR::mul(AR::mul(AR::mul(growth, sigma), cert_eps), bscale) &&
      dual_ray <= ray_eps && AR::div(dobj, nan_max(ynorm, tiny)) <= AR::mul(-cert_eps, bscale);
  const T prim_ray = AR::div(mx[1], nan_max(xnorm, tiny));
  const bool unbounded =
      at_period && xnorm >= guard &&
      AR::sub(xnorm, xg) >= AR::mul(AR::mul(AR::mul(growth, tau), cert_eps), cscale) &&
      prim_ray <= ray_eps && AR::div(pobj, nan_max(xnorm, tiny)) >= AR::mul(cert_eps, cscale) &&
      pres <= cert_eps;
  if (opt) status = OPTIMAL;
  else if (infeas) status = INFEASIBLE;
  else if (unbounded) status = UNBOUNDED;
  bool do_restart = false;
  if (status == RUNNING) {
    ++iters;
    const int c = inner + 1;
    do_restart = c >= restart;
    cnt = static_cast<T>(c);
    inner = do_restart ? 0 : c;
    if (do_restart) {
      xg = xnorm;
      yg = ynorm;
    }
  }
  return do_restart;
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
        T cnt = T(0);
        sh_restart = decide(s, mx, tau, sigma, anorm, bscale, cscale, tol, growth, restart,
                            status, iters, inner, xg, yg, cnt);
        sh_cnt = cnt;
        sh_status = status;
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

// Dynamic shared memory of one CTA of the cluster variant, in elements: the
// row slice of A (mr x n), the partial A'y and the gathered x1 (n each), the
// row vectors y, ax, y_sum, ax_sum, b, A x1 (mr each), the column vectors x, x_sum,
// c, x1 (nc each), the published partials (8) and the gathered ones
// (8 x MAX_CLUSTER).  kernels/cluster.py mirrors it.
constexpr int NPART = NSUM + NMAX;

__host__ __device__ inline size_t cluster_elems(int m, int n, int k) {
  const size_t mr = (size_t)((m + k - 1) / k), nc = (size_t)((n + k - 1) / k);
  return mr * n + 2 * (size_t)n + 6 * mr + 4 * nc + NPART + (size_t)NPART * MAX_CLUSTER;
}

template <typename T>
__global__ void __launch_bounds__(PDHG_THREADS)
pdhg_cluster_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ x_io, T* __restrict__ y_io, T* __restrict__ ax_io,
                    T* __restrict__ xs_io, T* __restrict__ ys_io, T* __restrict__ axs_io,
                    int* __restrict__ inner_io, T* __restrict__ xg_io, T* __restrict__ yg_io,
                    const T* __restrict__ tau_in, const T* __restrict__ sigma_in,
                    const T* __restrict__ anorm_in, const T* __restrict__ bscale_in,
                    const T* __restrict__ cscale_in, int* __restrict__ status_out,
                    int* __restrict__ iters_out, int m, int n, int cap, int restart, T tol,
                    T growth, int k) {
  using AR = Arith<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long lp = blockIdx.x / k;
  const int mr = (m + k - 1) / k, nc = (n + k - 1) / k;
  const int r0 = min(m, rank * mr), r1 = min(m, r0 + mr), rows = r1 - r0;
  const int c0 = min(n, rank * nc), c1 = min(n, c0 + nc), cols = c1 - c0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);  // rows r0..r1-1 of A
  T* part = as + (size_t)mr * n;           // this CTA's partial A'y, all columns
  T* xfull = part + n;                     // x1, gathered from the cluster
  T* yv = xfull + n;                       // the row vectors of rows r0..r1-1
  T* axv = yv + mr;
  T* ysv = axv + mr;
  T* axsv = ysv + mr;
  T* bv = axsv + mr;
  T* ax1v = bv + mr;                       // A x1 of rows r0..r1-1
  T* xv = ax1v + mr;                         // the column vectors of c0..c1-1
  T* xsv = xv + nc;
  T* cv = xsv + nc;
  T* x1v = cv + nc;
  T* pub = x1v + nc;                       // this CTA's 8 partials, read by the cluster
  T* stage = pub + NPART;                  // the cluster's k x 8 partials
  __shared__ T red_s[PDHG_WARPS][NSUM];
  __shared__ T red_m[PDHG_WARPS][NMAX];
  __shared__ int sh_status;
  __shared__ int sh_restart;
  __shared__ T sh_cnt;

  copy_async(as, a + lp * (long long)m * n + (long long)r0 * n, (long long)rows * n);
  const long long ro = lp * (long long)m + r0, co = lp * (long long)n + c0;
  for (int i = tid; i < rows; i += PDHG_THREADS) {
    yv[i] = y_io[ro + i];
    axv[i] = ax_io[ro + i];
    ysv[i] = ys_io[ro + i];
    axsv[i] = axs_io[ro + i];
    bv[i] = b[ro + i];
  }
  for (int j = tid; j < cols; j += PDHG_THREADS) {
    xv[j] = x_io[co + j];
    xsv[j] = xs_io[co + j];
    cv[j] = c[co + j];
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const T tau = tau_in[lp], sigma = sigma_in[lp];
  const T anorm = anorm_in[lp], bscale = bscale_in[lp], cscale = cscale_in[lp];
  // Thread 0 of every CTA keeps the per-LP scalars, with the same bits.
  int inner = inner_io[lp];
  T xg = xg_io[lp], yg = yg_io[lp];
  int status = RUNNING;
  int iters = 0;

  for (int step = 0; step < cap; ++step) {
    // ---- 1. the partial A'y of this CTA's rows (rows ascending), two
    // columns a thread (j and j + HALF) so that each y_i read serves two
    // sums; and the row-side partials.
    T s[NSUM] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T mx[NMAX] = {T(0), T(0)};
    for (int j = tid; j < n; j += 2 * HALF) {
      if (tid >= HALF) break;
      T acc = T(0);
      if (j + HALF < n) {
        T acc2 = T(0);
#pragma unroll 8
        for (int li = 0; li < rows; ++li) {
          const T yi = yv[li];
          const T* row = as + (size_t)li * n;
          acc = AR::add(acc, AR::mul(row[j], yi));
          acc2 = AR::add(acc2, AR::mul(row[j + HALF], yi));
        }
        part[j + HALF] = acc2;
      } else {
#pragma unroll 8
        for (int li = 0; li < rows; ++li) acc = AR::add(acc, AR::mul(as[(size_t)li * n + j], yv[li]));
      }
      part[j] = acc;
    }
    for (int li = tid; li < rows; li += PDHG_THREADS) {
      const T bi = bv[li], yi = yv[li], axi = axv[li];
      const T r = relu(AR::sub(axi, bi));
      s[0] = AR::add(s[0], AR::mul(r, r));
      s[3] = AR::add(s[3], AR::mul(bi, yi));
      s[5] = AR::add(s[5], AR::mul(yi, yi));
      mx[1] = nan_max(mx[1], relu(axi));
    }
    sync_cluster(cluster, k);  // 1: every partial A'y is ready

    // ---- 2-3. aty of this CTA's columns (the k partials in rank order, read
    // four at a time), the column-side partials, and x1, which does not
    // depend on the step's decision.
    for (int jj = tid; jj < cols; jj += PDHG_THREADS) {
      const int j = c0 + jj;
      T acc = T(0);
      for (int s0 = 0; s0 < k; s0 += 4) {
        T pv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s0 + u < k) pv[u] = cluster.map_shared_rank(part, s0 + u)[j];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s0 + u < k) acc = s0 + u == 0 ? pv[u] : AR::add(acc, pv[u]);
      }
      const T cj = cv[jj], xj = xv[jj];
      const T d = relu(AR::sub(cj, acc));
      s[1] = AR::add(s[1], AR::mul(d, d));
      s[2] = AR::add(s[2], AR::mul(cj, xj));
      s[4] = AR::add(s[4], AR::mul(xj, xj));
      mx[0] = nan_max(mx[0], relu(-acc));
      x1v[jj] = relu(AR::add(xj, AR::mul(tau, AR::sub(cj, acc))));
    }
    warp_reduce(s, mx);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NSUM; ++q) red_s[warp][q] = s[q];
#pragma unroll
      for (int q = 0; q < NMAX; ++q) red_m[warp][q] = mx[q];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < NSUM; ++q) s[q] = lane < PDHG_WARPS ? red_s[lane][q] : T(0);
#pragma unroll
      for (int q = 0; q < NMAX; ++q) mx[q] = lane < PDHG_WARPS ? red_m[lane][q] : T(0);
      warp_reduce(s, mx);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NSUM; ++q) pub[q] = s[q];
#pragma unroll
        for (int q = 0; q < NMAX; ++q) pub[NSUM + q] = mx[q];
      }
    }
    sync_cluster(cluster, k);  // 2: every CTA's partials and slice of x1 are published

    // ---- 4. the k x 8 partials and the whole x1, gathered over DSMEM; the
    // partials reduced in rank order by every CTA: the same status and
    // restart decision everywhere.
    if (tid < k * NPART) stage[tid] = cluster.map_shared_rank(pub, tid / NPART)[tid % NPART];
    for (int j = tid; j < n; j += PDHG_THREADS) {
      const int src = j / nc;
      xfull[j] = cluster.map_shared_rank(x1v, src)[j - src * nc];
    }
    __syncthreads();
    // ---- 5. the decision (thread 0), while the warps compute A x1 of this
    // CTA's rows, four rows a warp at a time (each x1_j read serves four
    // sums; a row sums its columns j = lane, lane + 32, ... in ascending
    // order, then a fixed shuffle tree).
    if (tid == 0) {
      T ts[NSUM], tm[NMAX];
#pragma unroll
      for (int q = 0; q < NSUM; ++q) ts[q] = stage[q];
#pragma unroll
      for (int q = 0; q < NMAX; ++q) tm[q] = stage[NSUM + q];
      for (int src = 1; src < k; ++src) {
#pragma unroll
        for (int q = 0; q < NSUM; ++q) ts[q] = AR::add(ts[q], stage[src * NPART + q]);
#pragma unroll
        for (int q = 0; q < NMAX; ++q) tm[q] = nan_max(tm[q], stage[src * NPART + NSUM + q]);
      }
      T cnt = T(0);
      sh_restart = decide(ts, tm, tau, sigma, anorm, bscale, cscale, tol, growth, restart, status,
                          iters, inner, xg, yg, cnt);
      sh_cnt = cnt;
      sh_status = status;
    }
    for (int li0 = warp; li0 < rows; li0 += 4 * PDHG_WARPS) {
      const T* row[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int li = li0 + u * PDHG_WARPS;
        row[u] = as + (size_t)(li < rows ? li : li0) * n;
      }
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const T xj = xfull[j];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = AR::add(acc[u], AR::mul(row[u][j], xj));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[u] = AR::add(acc[u], __shfl_down_sync(0xffffffffu, acc[u], off));
        const int li = li0 + u * PDHG_WARPS;
        if (lane == 0 && li < rows) ax1v[li] = acc[u];
      }
    }
    __syncthreads();
    if (sh_status != RUNNING) break;  // every CTA of the cluster stops here
    const bool dr = sh_restart != 0;
    const T cnt = sh_cnt;

    // ---- 6. the primal sums and restart of this CTA's columns, y1 and the
    // dual sums and restart of its rows.
    for (int jj = tid; jj < cols; jj += PDHG_THREADS) {
      const T x1 = x1v[jj];
      const T xs1 = AR::add(xsv[jj], x1);
      xv[jj] = dr ? AR::div(xs1, cnt) : x1;
      xsv[jj] = dr ? T(0) : xs1;
    }
    for (int li = tid; li < rows; li += PDHG_THREADS) {
      const T ax1 = ax1v[li], axi = axv[li], yi = yv[li];
      const T y1 =
          relu(AR::add(yi, AR::mul(sigma, AR::sub(AR::sub(AR::mul(T(2), ax1), axi), bv[li]))));
      const T ys1 = AR::add(ysv[li], y1);
      const T axs1 = AR::add(axsv[li], ax1);
      yv[li] = dr ? AR::div(ys1, cnt) : y1;
      ysv[li] = dr ? T(0) : ys1;
      axv[li] = dr ? AR::div(axs1, cnt) : ax1;
      axsv[li] = dr ? T(0) : axs1;
    }
    __syncthreads();
  }
  sync_cluster(cluster, k);  // no CTA leaves while another reads its shared memory

  // ---- the terminal state back to the caller's buffers.
  for (int i = tid; i < rows; i += PDHG_THREADS) {
    y_io[ro + i] = yv[i];
    ax_io[ro + i] = axv[i];
    ys_io[ro + i] = ysv[i];
    axs_io[ro + i] = axsv[i];
  }
  for (int j = tid; j < cols; j += PDHG_THREADS) {
    x_io[co + j] = xv[j];
    xs_io[co + j] = xsv[j];
  }
  if (rank == 0 && tid == 0) {
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

template <typename T>
int launch_cluster_variant(const void* a, const void* b, const void* c, void* x, void* y,
                           void* ax, void* xs, void* ys, void* axs, void* inner, void* xg,
                           void* yg, const void* tau, const void* sigma, const void* anorm,
                           const void* bscale, const void* cscale, void* status, void* iters,
                           int bsz, int m, int n, int cap, int restart, double tol,
                           double growth, int k, void* stream) {
  if (bsz <= 0) return 0;
  return (int)launch_cluster(
      pdhg_cluster_kernel<T>, bsz, k, PDHG_THREADS, sizeof(T) * cluster_elems(m, n, k),
      (cudaStream_t)stream, (const T*)a, (const T*)b, (const T*)c, (T*)x, (T*)y, (T*)ax, (T*)xs,
      (T*)ys, (T*)axs, (int*)inner, (T*)xg, (T*)yg, (const T*)tau, (const T*)sigma,
      (const T*)anorm, (const T*)bscale, (const T*)cscale, (int*)status, (int*)iters, m, n, cap,
      restart, static_cast<T>(tol), static_cast<T>(growth), k);
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

#define PDHG_CLUSTER_ARGS                                                                    \
  const void *a, const void *b, const void *c, void *x, void *y, void *ax, void *xs, void *ys, \
      void *axs, void *inner, void *xg, void *yg, const void *tau, const void *sigma,          \
      const void *anorm, const void *bscale, const void *cscale, void *status, void *iters,    \
      int bsz, int m, int n, int cap, int restart, double tol, double growth, int k,           \
      void *stream

int pdhg_cluster_f32(PDHG_CLUSTER_ARGS) {
  return launch_cluster_variant<float>(a, b, c, x, y, ax, xs, ys, axs, inner, xg, yg, tau, sigma,
                                       anorm, bscale, cscale, status, iters, bsz, m, n, cap,
                                       restart, tol, growth, k, stream);
}

int pdhg_cluster_f64(PDHG_CLUSTER_ARGS) {
  return launch_cluster_variant<double>(a, b, c, x, y, ax, xs, ys, axs, inner, xg, yg, tau,
                                        sigma, anorm, bscale, cscale, status, iters, bsz, m, n,
                                        cap, restart, tol, growth, k, stream);
}

// Dynamic shared memory of one CTA of the cluster variant (bytes).
long long pdhg_cluster_smem(int m, int n, int k, int item) {
  return (long long)item * (long long)cluster_elems(m, n, k);
}

// cudaOccupancyMaxActiveClusters of the cluster variant at k CTAs and `smem`
// bytes; a negative value is a CUDA error code.
int pdhg_cluster_occupancy(int item, int k, long long smem) {
  return item == 8 ? active_clusters(pdhg_cluster_kernel<double>, k, PDHG_THREADS, (size_t)smem)
                   : active_clusters(pdhg_cluster_kernel<float>, k, PDHG_THREADS, (size_t)smem);
}

const char* pdhg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
