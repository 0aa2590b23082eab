// Shared-A revised simplex for Hopper (sm_90a), in two variants, with a
// solve/resume entry and a sweep entry.
//
// Replaces: src/repro/kernels/revised_pallas.py:_kernel (the Pallas TPU
// kernel that runs src/repro/core/revised.py:iteration_step and finalize over
// a VMEM tile of LPs against one VMEM-resident A), and the lax.scan of
// src/repro/core/revised.py:sweep_batched around it.
//
// The function, per LP and step: the basic costs c_B under the current phase;
// y = c_B . B^-1 and w = y . sgn; the reduced costs (c or 0) - w . A of the
// originals and -w of the slacks, with the phase-I value -c_B . x_B in slot 0;
// the entering column under lpc/rpc/bland; u = B^-1 . (sgn * column of [A|I]);
// the basic columns' reduced costs set to 0 (as the plain version does: priced
// afresh they are rounding noise that can exceed tol and let a basic column
// enter); the ratio test with the degenerate-artificial escape; and the rank-1
// product-form update of binv and xb around the pivot.  After the loop,
// status ITER_LIMIT for LPs still running, the primal point x and the
// phase-II objective c_B . x_B (ascending rows; -inf where not OPTIMAL).
//
// What bounds it on this card: per pivot about 6 m^2 + 2 m n flops (y, u and
// the binv update are 2 m^2 each, the pricing 2 m n) over binv, which y and u
// read and the update reads and writes.  At 100x100 in float32 binv is 40 KB
// per LP; held in device memory it crosses the memory system about four
// times a pivot (the global variant, ~1.8 TB for the paper's type 1); held on
// chip it is shared-memory traffic, barriers and the m-long sequential sums.
//
// The resident variant (the main paths; kernels/cluster.py:plan_revised picks
// it wherever its shared memory fits): one CTA per LP holds binv, basis, xb,
// the LP's costs and every per-step vector in shared memory for the whole
// loop.  binv is loaded once with cp.async and written back at the end, so a
// resume is the same launch.  What bounds it then is shared-memory traffic
// (y, u and the update read binv three times and write it once a pivot) and,
// at one CTA an SM, latency.  So u_i (a row a thread) and the rank-1 update
// (a warp a row, the lane's part of the normalised row in registers) move
// binv in 16-byte loads and stores, and y_j reads a column a thread
// (neighbouring threads, neighbouring entries).  binv's row stride is an odd
// number of 16-byte vectors, so the eight threads of a quarter warp loading
// 16 bytes of their own rows (u) touch 32 distinct banks.  A (m x n) is
// shared by every CTA.  Where CTAs share an SM it is read through the
// read-only path, 8 * VW rows in flight (40 KB at type 1, which L1 holds
// beside four CTAs' shared memory).  Where a CTA has its SM alone (type 2,
// 171 KB) the pricing is bound by L2 latency, so the CTA stages A's rows
// through two buffers in the shared memory left (cp.async by every thread,
// the first rows issued before y), and a column a thread sums from there.
//
// The global variant (shapes past the resident budget): the same loop with
// binv updated in place in the caller's device memory, the update flat over
// m*m entries.
//
// The sweep entry (both variants) carries a (T, B, n) stack of cost rows in
// one launch: each CTA loops over the T steps of its LP, restarting from its
// own terminal state where the step before ended OPTIMAL (warm) and from the
// cold state elsewhere, with the step counter (the RPC key) reset to 0 each
// step, as the plain sweep's one solve per step does.  The global variant's
// binv lives in a scratch buffer the wrapper allocates.
//
// Determinism contract (bit-identical to the plain PyTorch version,
// src/repro_torch/core/revised.py, on the card): every multiply, add,
// subtract and divide is a separately rounded IEEE operation (__fmul_rn & co.,
// and the library is built -fmad=false); every contraction sums its inner
// index in ascending order from 0; the entering and leaving reductions break
// ties toward the lowest index; tol and BIG are compared in the LP's type.
// Each CTA loops while step < cap and its LP is RUNNING, which equals the
// reference's lockstep loop: a finished LP is frozen there, and the RPC
// counter is the LP's own loop index.

#include "cluster.cuh"
#include "common.cuh"

namespace {

using namespace repro_kernels;

// Elements of one 16-byte vector: the resident variant moves binv and the
// per-step vectors through shared memory in 16-byte loads and stores.
template <typename T>
constexpr int VW = 16 / (int)sizeof(T);

template <typename T>
struct alignas(16) Vec {
  T v[VW<T>];
};

template <typename T>
__device__ __forceinline__ Vec<T> ld16(const T* p) {
  return *reinterpret_cast<const Vec<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const Vec<T>& x) {
  *reinterpret_cast<Vec<T>*>(p) = x;
}

__host__ __device__ inline int round_up(int x, int v) { return (x + v - 1) / v * v; }

// The row stride of binv in shared memory: a whole number of 16-byte
// vectors, and an odd number of them, so the eight threads of a quarter warp
// that each load 16 bytes of their own row (u = B^-1 . me, a row a thread)
// touch 32 distinct banks.
__host__ __device__ inline int binv_ld(int m, int vw) {
  const int ld = round_up(m, vw);
  return (ld / vw) % 2 ? ld : ld + vw;
}

// Shared memory one SM holds, and the part of it the runtime keeps for each
// CTA: two resident CTAs an SM need twice their own budget plus that.
constexpr int SM_SMEM = 233472;
constexpr int CTA_RESERVE = 1024;

// Elements of one of the two buffers that stage `rows` rows of A: room for
// the shift to the source's alignment, a whole number of 16-byte vectors.
__host__ __device__ inline int stage_span(int rows, int n, int vw) {
  return rows ? round_up(rows * n, vw) + vw : 0;
}

// Shared memory of the per-step vectors (both variants), each a whole number
// of 16-byte vectors: sgn, cb, w, me, u, npr and xb (m each), the LP's costs
// (n), the objective row (1 + n + m); the two buffers that stage A's rows
// (`rows` a buffer, 0 for none); then the basis (m ints).
__host__ __device__ inline size_t vec_smem(int m, int n, size_t item, int rows) {
  const int vw = 16 / (int)item;
  return item * (7 * (size_t)round_up(m, vw) + round_up(n, vw) + round_up(1 + n + m, vw) +
                 2 * (size_t)stage_span(rows, n, vw)) +
         sizeof(int) * (size_t)m;
}

// Rows of A each staging buffer holds in the resident variant: 0 where two
// CTAs share an SM (A then stays in L1 beside them) or where the pricing has
// more columns than threads; else as many as the CTA's budget leaves, a
// multiple of VW, at most the padded m.
__host__ __device__ inline int stage_rows(int m, int n, size_t item) {
  const int vw = 16 / (int)item;
  const long long base =
      (long long)item * m * binv_ld(m, vw) + (long long)vec_smem(m, n, item, 0);
  if (n > THREADS || 2 * (base + STATIC_RESERVE + CTA_RESERVE) <= SM_SMEM) return 0;
  const long long room = (SMEM_LIMIT - STATIC_RESERVE - base) / (long long)item / 2 - 2 * vw;
  long long rows = room / n;
  rows -= rows % vw;
  if (rows > round_up(m, vw)) rows = round_up(m, vw);
  return rows >= vw ? (int)rows : 0;
}

// Dynamic shared memory of one CTA of the resident variant: binv in m rows of
// stride binv_ld, then the vectors and staging buffers.
// kernels/cluster.py:revised_smem mirrors it.
__host__ __device__ inline size_t resident_smem(int m, int n, size_t item) {
  return item * (size_t)m * binv_ld(m, 16 / (int)item) +
         vec_smem(m, n, item, stage_rows(m, n, item));
}

// The normalised pivot row a lane keeps in registers during the resident
// update, in vectors of 16 bytes: NPR of them, so rows of up to
// 32 * NPR * VW elements (256 in float32, 192 in float64: past every shape
// the resident budget holds).
template <typename T>
constexpr int NPR = sizeof(T) == 4 ? 2 : 3;

// The per-step vectors of one LP in shared memory.
template <typename T>
struct Work {
  T *sgn, *cb, *w, *me, *u, *npr, *xb, *cs, *obj, *stage;
  int* bas;
  int rows;  // of A a staging buffer holds (0: no staging)
};

template <typename T>
__device__ __forceinline__ Work<T> carve(T* p, int m, int n, int rows) {
  const int mv = round_up(m, VW<T>);
  Work<T> s;
  s.sgn = p;
  s.cb = s.sgn + mv;
  s.w = s.cb + mv;
  s.me = s.w + mv;
  s.u = s.me + mv;
  s.npr = s.u + mv;
  s.xb = s.npr + mv;
  s.cs = s.xb + mv;
  s.obj = s.cs + round_up(n, VW<T>);
  s.stage = s.obj + round_up(1 + n + m, VW<T>);
  s.bas = reinterpret_cast<int*>(s.stage + 2 * stage_span(rows, n, VW<T>));
  s.rows = rows;
  return s;
}

// Four CTAs an SM at the paper's type 1 (44 KB each) need at most 64
// registers a thread; the global variant, bound by device-memory latency,
// needs the occupancy as much.
constexpr int MIN_BLOCKS = 4;

// y_j = sum_i c_B,i binv[i,j] (i ascending) and w = y . sgn, a column a
// thread: neighbouring threads read neighbouring entries of a row.  (VW
// columns a thread with 16-byte loads measured slower at type 2, where one
// CTA an SM leaves too few warps to hide the fewer, longer chains.)
template <typename T>
__device__ __forceinline__ void dual_prices(const T* bi, int ld, const Work<T>& s, int m) {
  using AR = Arith<T>;
  for (int j = threadIdx.x; j < m; j += THREADS) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc = AR::add(acc, AR::mul(s.cb[i], bi[(size_t)i * ld + j]));
    s.w[j] = AR::mul(acc, s.sgn[j]);
  }
}

// The reduced costs of the originals, (c or 0) - w . A (i ascending), a
// column a thread; A through the read-only path, 8 * VW rows in flight.
template <typename T>
__device__ __forceinline__ void price_columns(const T* __restrict__ a, const Work<T>& s, int m,
                                              int n, int phase) {
  using AR = Arith<T>;
  constexpr int V = VW<T>;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    T acc = T(0);
    int i = 0;
#pragma unroll 8
    for (; i + V <= m; i += V) {
      const Vec<T> wv = ld16(s.w + i);
#pragma unroll
      for (int d = 0; d < V; ++d)
        acc = AR::add(acc, AR::mul(wv.v[d], __ldg(a + (size_t)(i + d) * n + k)));
    }
    for (; i < m; ++i) acc = AR::add(acc, AR::mul(s.w[i], __ldg(a + (size_t)i * n + k)));
    s.obj[1 + k] = AR::sub(phase == 1 ? T(0) : s.cs[k], acc);
  }
}

// Start cp.async copies of A's rows [i0, min(i0 + rows, m)) into a staging
// buffer, shifted to the source's alignment (copy_async then moves 16 bytes
// a copy), as one group; returns where A[i0, 0] lands.
template <typename T>
__device__ __forceinline__ const T* stage_a(T* buf, const T* a, int i0, int rows, int m, int n) {
  const T* src = a + (size_t)i0 * n;
  T* dst = buf + (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
  copy_async(dst, src, (long long)min(rows, m - i0) * n);
  return dst;
}

// The pricing with A staged through shared memory, s.rows rows a buffer:
// every thread copies, a column a thread sums (n <= THREADS), i ascending.
// The caller issued rows [0, s.rows) into buffer 0 (`first`); the two
// buffers alternate, and the barrier after each buffer's reads comes before
// its next copy.
template <typename T>
__device__ __forceinline__ void price_columns_staged(const T* __restrict__ a, const Work<T>& s,
                                                     const T* first, int m, int n, int phase) {
  using AR = Arith<T>;
  const int k = threadIdx.x;
  const int span = stage_span(s.rows, n, VW<T>);
  const T* cur = first;
  T acc = T(0);
  for (int i0 = 0, c = 0; i0 < m; i0 += s.rows, ++c) {
    const T* next = nullptr;
    if (i0 + s.rows < m)
      next = stage_a(s.stage + ((c + 1) & 1) * span, a, i0 + s.rows, s.rows, m, n);
    else
      __pipeline_commit();  // an empty group: wait_prior(1) then waits for this buffer
    __pipeline_wait_prior(1);
    __syncthreads();
    if (k < n) {
      const int rows = min(s.rows, m - i0);
      for (int i = 0; i < rows; ++i)
        acc = AR::add(acc, AR::mul(s.w[i0 + i], cur[(size_t)i * n + k]));
    }
    __syncthreads();
    cur = next;
  }
  if (k < n) s.obj[1 + k] = AR::sub(phase == 1 ? T(0) : s.cs[k], acc);
}

// u_i = sum_j binv[i,j] me_j (j ascending), a row a thread.  Resident: 16-byte
// loads of the row and of me.
template <typename T, bool RES>
__device__ __forceinline__ void entering_column(const T* bi, int ld, const Work<T>& s, int m) {
  using AR = Arith<T>;
  constexpr int V = VW<T>;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const T* r = bi + (size_t)i * ld;
    T acc = T(0);
    int j = 0;
    if (RES) {
      for (; j + V <= m; j += V) {
        const Vec<T> b = ld16(r + j), e = ld16(s.me + j);
#pragma unroll
        for (int c = 0; c < V; ++c) acc = AR::add(acc, AR::mul(b.v[c], e.v[c]));
      }
    }
    for (; j < m; ++j) acc = AR::add(acc, AR::mul(r[j], s.me[j]));
    s.u[i] = acc;
  }
}

// The rank-1 update binv[i,:] -= u_i * npr (row l = npr).  Resident: a warp
// a row, 16 bytes a lane, the lane's part of npr held in registers (the
// padding columns are updated too: they stay 0).  Global: flat over m*m.
template <typename T, bool RES>
__device__ __forceinline__ void update_binv(T* bi, int ld, const Work<T>& s, int m, int l) {
  using AR = Arith<T>;
  constexpr int V = VW<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (RES) {
    const int chunks = round_up(m, V) / V;
    Vec<T> np[NPR<T>];
#pragma unroll
    for (int k = 0; k < NPR<T>; ++k)
      if (lane + 32 * k < chunks) np[k] = ld16(s.npr + (lane + 32 * k) * V);
    for (int i = warp; i < m; i += WARPS) {
      T* r = bi + (size_t)i * ld;
      const T ui = s.u[i];
#pragma unroll
      for (int k = 0; k < NPR<T>; ++k) {
        const int c = lane + 32 * k;
        if (c >= chunks) continue;
        Vec<T> x = np[k];
        if (i != l) {
          x = ld16(r + c * V);
#pragma unroll
          for (int e = 0; e < V; ++e) x.v[e] = AR::sub(x.v[e], AR::mul(ui, np[k].v[e]));
        }
        st16(r + c * V, x);
      }
    }
  } else {
    const int total = m * m;
    for (int k = tid; k < total; k += THREADS) {
      const int i = k / m;
      const int j = k - i * m;
      bi[k] = i == l ? s.npr[j] : AR::sub(bi[k], AR::mul(s.u[i], s.npr[j]));
    }
  }
}

// One LP's pivot loop, from the state in (bi, s.bas, s.xb, phase), up to cap
// steps.  bi is binv in shared memory (resident, stride ld) or in device
// memory (global, stride m).  Ends with a barrier.
template <typename T, bool RES>
__device__ __forceinline__ void pivot_loop(const T* __restrict__ a, T* bi, int ld,
                                           const Work<T>& s, int m, int n, int cap, int rule,
                                           uint32_t seed, uint32_t row, T tol, T feas_tol,
                                           T* red_v, int* red_i, int& phase, int& status,
                                           int& iters) {
  using AR = Arith<T>;
  const int q = 1 + n + m;
  const int art_start = 1 + n + m;
  const int tid = threadIdx.x;
  const T big = static_cast<T>(1e30);
  const T half_big = static_cast<T>(5e29);
  // The phase-I value goes to the last thread, during y (which takes the
  // first m threads).
  const int obj0_tid = THREADS - 1;
  // The normalised row covers binv's padding columns in the resident layout.
  const int npr_len = RES ? round_up(m, VW<T>) : m;
  status = RUNNING;
  iters = 0;

  for (int step = 0; step < cap; ++step) {
    // ---- basic costs under the current phase (-1/-0 on artificials in phase I).
    for (int i = tid; i < m; i += THREADS) {
      const int id = s.bas[i];
      if (phase == 1) {
        s.cb[i] = -(id >= art_start ? T(1) : T(0));
      } else {
        const int k = min(max(id - 1, 0), n - 1);
        s.cb[i] = (id >= 1 && id <= n) ? s.cs[k] : T(0);
      }
    }
    __syncthreads();
    // A's first rows start on their way while y is summed.
    const T* first = RES && s.rows ? stage_a(s.stage, a, 0, s.rows, m, n) : nullptr;
    // ---- objective row: [phase-I value, (c or 0) - w . A, -w].
    if (tid == obj0_tid) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc = AR::add(acc, AR::mul(s.cb[i], s.xb[i]));
      s.obj[0] = -acc;
    }
    dual_prices<T>(bi, ld, s, m);
    __syncthreads();
    if (RES && s.rows) price_columns_staged<T>(a, s, first, m, n, phase);
    else price_columns<T>(a, s, m, n, phase);
    for (int i = tid; i < m; i += THREADS) s.obj[1 + n + i] = -s.w[i];
    __syncthreads();
    // Basic columns price to rounding noise; their reduced cost is 0.
    for (int i = tid; i < m; i += THREADS) {
      const int id = s.bas[i];
      if (id < q) s.obj[id] = T(0);
    }
    __syncthreads();

    // ---- entering column.
    T max_c;
    int e;
    select_entering<T>(s.obj, q, q, rule, tol, seed, (uint32_t)step, row, red_v, red_i, max_c,
                       e);
    if (max_c <= tol) {
      if (phase == 2) { status = OPTIMAL; break; }
      if (!(s.obj[0] <= feas_tol)) { status = INFEASIBLE; break; }
      phase = 2;  // pricing is recomputed from (basis, phase) next step
      continue;
    }

    // ---- u = B^-1 . (sgn * column e of [A | I]), j ascending per row.
    for (int i = tid; i < m; i += THREADS) {
      T v;
      if (e <= n) v = __ldg(a + (size_t)i * n + min(max(e - 1, 0), n - 1));
      else v = i == min(max(e - 1 - n, 0), m - 1) ? T(1) : T(0);
      s.me[i] = AR::mul(s.sgn[i], v);
    }
    __syncthreads();
    entering_column<T, RES>(bi, ld, s, m);
    __syncthreads();

    // ---- ratio test with the degenerate-artificial escape.
    T rv = static_cast<T>(INFINITY);
    int ri = INT_MAX;
    for (int i = tid; i < m; i += THREADS) {
      const T ui = s.u[i], xi = s.xb[i];
      T r = ui > tol ? AR::div(xi, ui) : big;
      if (s.bas[i] >= art_start && xi <= tol && ui < -tol) r = T(0);
      if (better<T, false>(r, i, rv, ri)) { rv = r; ri = i; }
    }
    T min_ratio;
    int l;
    block_arg<T, false>(rv, ri, red_v, red_i, min_ratio, l);
    if (min_ratio >= half_big) { status = UNBOUNDED; break; }

    // ---- pivot: stage the normalised row, then the rank-1 sweeps.
    const T pe = s.u[l];
    const T pe_safe = fabs(pe) > tol ? pe : T(1);
    for (int j = tid; j < npr_len; j += THREADS)
      s.npr[j] = AR::div(bi[(size_t)l * ld + j], pe_safe);
    const T npx = AR::div(s.xb[l], pe_safe);
    __syncthreads();
    update_binv<T, RES>(bi, ld, s, m, l);
    for (int i = tid; i < m; i += THREADS)
      s.xb[i] = i == l ? npx : AR::sub(s.xb[i], AR::mul(s.u[i], npx));
    if (tid == 0) s.bas[l] = e;
    ++iters;
    __syncthreads();
  }
  if (status == RUNNING) status = ITER_LIMIT;
  __syncthreads();
}

// The primal point x_j = xb of the row where x_j is basic (rows ascending)
// and the phase-II objective c_B . x_B (rows ascending); 0 and -inf where
// the LP is not OPTIMAL.
template <typename T>
__device__ __forceinline__ void write_solution(const Work<T>& s, int m, int n, int status,
                                               T* __restrict__ x_out, T* __restrict__ obj_out) {
  using AR = Arith<T>;
  const bool ok = status == OPTIMAL;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc = AR::add(acc, s.bas[i] == j + 1 ? s.xb[i] : T(0));
    x_out[j] = ok ? acc : T(0);
  }
  if (threadIdx.x == 0) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) {
      const int id = s.bas[i];
      const T cv = (id >= 1 && id <= n) ? s.cs[id - 1] : T(0);
      acc = AR::add(acc, AR::mul(cv, s.xb[i]));
    }
    *obj_out = ok ? acc : -static_cast<T>(INFINITY);
  }
}

// Issue cp.async copies of an m x m row-major matrix into shared rows of
// stride ld, one element each (the padded rows break the 16-byte alignment
// of the source), commit them as one group, and zero the padding columns.
template <typename T>
__device__ void copy_rows_async(T* dst, int ld, const T* src, int m) {
  const int total = m * m;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int i = idx / m;
    __pipeline_memcpy_async(dst + (size_t)i * ld + (idx - i * m), src + idx, sizeof(T));
  }
  __pipeline_commit();
  const int pad = ld - m;
  for (int idx = threadIdx.x; idx < m * pad; idx += THREADS)
    dst[(size_t)(idx / pad) * ld + m + idx % pad] = T(0);
}

// Solve or resume: the state (binv, basis, xb, phase) is read from and
// written back to the caller's buffers.
template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
revised_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ binv, int* __restrict__ basis_io, T* __restrict__ xb_io,
               int* __restrict__ phase_io, const T* __restrict__ feas, T* __restrict__ obj_out,
               T* __restrict__ x_out, int* __restrict__ status_out, int* __restrict__ iters_out,
               int m, int n, int cap, int rule, uint32_t seed, uint32_t row0, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_v[WARPS + 1];
  __shared__ int red_i[WARPS + 1];
  const int tid = threadIdx.x;
  const long long lp = blockIdx.x;
  const int ld = RES ? binv_ld(m, VW<T>) : m;
  T* gbi = binv + lp * (long long)m * m;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* bi = RES ? base : gbi;
  const Work<T> s = carve(RES ? base + (size_t)m * ld : base, m, n,
                          RES ? stage_rows(m, n, sizeof(T)) : 0);

  if (RES) copy_rows_async(bi, ld, gbi, m);
  for (int i = tid; i < m; i += THREADS) {
    s.sgn[i] = b[lp * m + i] < T(0) ? T(-1) : T(1);
    s.xb[i] = xb_io[lp * m + i];
    s.bas[i] = basis_io[lp * m + i];
  }
  for (int k = tid; k < n; k += THREADS) s.cs[k] = c[lp * n + k];
  int phase = phase_io[lp];
  if (RES) __pipeline_wait_prior(0);
  __syncthreads();

  int status, iters;
  pivot_loop<T, RES>(a, bi, ld, s, m, n, cap, rule, seed, row0 + (uint32_t)lp, tol, feas[lp],
                     red_v, red_i, phase, status, iters);

  write_solution(s, m, n, status, x_out + lp * n, obj_out + lp);
  if (RES) {
    for (int idx = tid; idx < m * m; idx += THREADS) {
      const int i = idx / m;
      gbi[idx] = bi[(size_t)i * ld + (idx - i * m)];
    }
  }
  for (int i = tid; i < m; i += THREADS) {
    xb_io[lp * m + i] = s.xb[i];
    basis_io[lp * m + i] = s.bas[i];
  }
  if (tid == 0) {
    status_out[lp] = status;
    iters_out[lp] = iters;
    phase_io[lp] = phase;
  }
}

// The sweep: steps x (B, n) cost rows over one (A, b).  Outputs are
// (steps, B[, n]); scratch is the global variant's binv, (B, m, m).
template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
revised_sweep_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ c_stack, T* __restrict__ scratch,
                     const T* __restrict__ feas, T* __restrict__ obj_out,
                     T* __restrict__ x_out, int* __restrict__ status_out,
                     int* __restrict__ iters_out, int bsz, int steps, int m, int n, int cap,
                     int rule, uint32_t seed, T tol, int warm) {
  using AR = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_v[WARPS + 1];
  __shared__ int red_i[WARPS + 1];
  const int tid = threadIdx.x;
  const long long lp = blockIdx.x;
  const int ld = RES ? binv_ld(m, VW<T>) : m;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* bi = RES ? base : scratch + lp * (long long)m * m;
  const Work<T> s = carve(RES ? base + (size_t)m * ld : base, m, n,
                          RES ? stage_rows(m, n, sizeof(T)) : 0);
  const T feas_tol = feas[lp];

  bool neg = false;
  for (int i = tid; i < m; i += THREADS) {
    const T bi_ = b[lp * m + i];
    s.sgn[i] = bi_ < T(0) ? T(-1) : T(1);
    neg = neg || bi_ < T(0);
  }
  const int cold_phase = __syncthreads_or(neg) ? 1 : 2;

  int phase = cold_phase, status = RUNNING, iters = 0;
  for (int t = 0; t < steps; ++t) {
    if (warm && status == OPTIMAL) {
      phase = 2;  // the step before's terminal state, in phase II
    } else {
      // The cold start: binv = I (padding columns 0), the slack or
      // artificial basis, xb = sgn * b.
      for (int idx = tid; idx < m * ld; idx += THREADS) {
        const int i = idx / ld, j = idx - i * ld;
        bi[idx] = i == j ? T(1) : T(0);
      }
      for (int i = tid; i < m; i += THREADS) {
        const T bv = b[lp * m + i];
        s.bas[i] = bv < T(0) ? 1 + n + m + i : 1 + n + i;
        s.xb[i] = AR::mul(s.sgn[i], bv);
      }
      phase = cold_phase;
    }
    const long long at = (long long)t * bsz + lp;
    for (int k = tid; k < n; k += THREADS) s.cs[k] = c_stack[at * n + k];
    __syncthreads();
    pivot_loop<T, RES>(a, bi, ld, s, m, n, cap, rule, seed, (uint32_t)lp, tol, feas_tol, red_v,
                       red_i, phase, status, iters);
    write_solution(s, m, n, status, x_out + at * n, obj_out + at);
    if (tid == 0) {
      status_out[at] = status;
      iters_out[at] = iters;
    }
    __syncthreads();  // the solution is read before the next step's start overwrites it
  }
}

// The dynamic shared memory attribute of a launch; refuses
// (cudaErrorInvalidValue) a resident launch past the budget or past the rows
// the update's registers hold.  The L1/shared split is left to the runtime,
// which leaves L1 room for A at the paper's type 1.
template <typename T, typename Kernel>
cudaError_t prepare(Kernel kernel, bool resident, int m, size_t smem) {
  if (resident && (smem + STATIC_RESERVE > (size_t)SMEM_LIMIT || m > 32 * NPR<T> * VW<T>))
    return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Resident CTAs an SM of `kernel` at `smem` bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative value is a
// CUDA error code.
template <typename T, typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  cudaError_t err = prepare<T>(kernel, true, 0, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T, bool RES>
int launch_solve(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
                 void* phase, const void* feas, void* obj, void* x, void* status, void* iters,
                 int bsz, int m, int n, int cap, int rule, unsigned seed, unsigned row0,
                 double tol, void* stream) {
  if (bsz <= 0) return 0;
  const size_t smem = RES ? resident_smem(m, n, sizeof(T)) : vec_smem(m, n, sizeof(T), 0);
  cudaError_t err = prepare<T>(revised_kernel<T, RES>, RES, m, smem);
  if (err != cudaSuccess) return (int)err;
  revised_kernel<T, RES><<<bsz, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)binv, (int*)basis, (T*)xb, (int*)phase,
      (const T*)feas, (T*)obj, (T*)x, (int*)status, (int*)iters, m, n, cap, rule,
      (uint32_t)seed, (uint32_t)row0, static_cast<T>(tol));
  return (int)cudaGetLastError();
}

template <typename T, bool RES>
int launch_sweep(const void* a, const void* b, const void* c_stack, void* scratch,
                 const void* feas, void* obj, void* x, void* status, void* iters, int bsz,
                 int steps, int m, int n, int cap, int rule, unsigned seed, double tol, int warm,
                 void* stream) {
  if (bsz <= 0 || steps <= 0) return 0;
  const size_t smem = RES ? resident_smem(m, n, sizeof(T)) : vec_smem(m, n, sizeof(T), 0);
  cudaError_t err = prepare<T>(revised_sweep_kernel<T, RES>, RES, m, smem);
  if (err != cudaSuccess) return (int)err;
  revised_sweep_kernel<T, RES><<<bsz, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c_stack, (T*)scratch, (const T*)feas, (T*)obj, (T*)x,
      (int*)status, (int*)iters, bsz, steps, m, n, cap, rule, (uint32_t)seed,
      static_cast<T>(tol), warm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Solve or resume B LPs; resident != 0 takes the resident variant.
int revised_f32(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
                void* phase, const void* feas, void* obj, void* x, void* status, void* iters,
                int bsz, int m, int n, int cap, int rule, unsigned seed, unsigned row0,
                double tol, int resident, void* stream) {
  if (resident)
    return launch_solve<float, true>(a, b, c, binv, basis, xb, phase, feas, obj, x, status,
                                     iters, bsz, m, n, cap, rule, seed, row0, tol, stream);
  return launch_solve<float, false>(a, b, c, binv, basis, xb, phase, feas, obj, x, status,
                                    iters, bsz, m, n, cap, rule, seed, row0, tol, stream);
}

int revised_f64(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
                void* phase, const void* feas, void* obj, void* x, void* status, void* iters,
                int bsz, int m, int n, int cap, int rule, unsigned seed, unsigned row0,
                double tol, int resident, void* stream) {
  if (resident)
    return launch_solve<double, true>(a, b, c, binv, basis, xb, phase, feas, obj, x, status,
                                      iters, bsz, m, n, cap, rule, seed, row0, tol, stream);
  return launch_solve<double, false>(a, b, c, binv, basis, xb, phase, feas, obj, x, status,
                                     iters, bsz, m, n, cap, rule, seed, row0, tol, stream);
}

// The sweep over `steps` cost rows per LP in one launch; scratch is the
// global variant's binv (unused by the resident variant).
int revised_sweep_f32(const void* a, const void* b, const void* c_stack, void* scratch,
                      const void* feas, void* obj, void* x, void* status, void* iters, int bsz,
                      int steps, int m, int n, int cap, int rule, unsigned seed, double tol,
                      int warm, int resident, void* stream) {
  if (resident)
    return launch_sweep<float, true>(a, b, c_stack, scratch, feas, obj, x, status, iters,
                                     bsz, steps, m, n, cap, rule, seed, tol, warm, stream);
  return launch_sweep<float, false>(a, b, c_stack, scratch, feas, obj, x, status, iters,
                                    bsz, steps, m, n, cap, rule, seed, tol, warm, stream);
}

int revised_sweep_f64(const void* a, const void* b, const void* c_stack, void* scratch,
                      const void* feas, void* obj, void* x, void* status, void* iters, int bsz,
                      int steps, int m, int n, int cap, int rule, unsigned seed, double tol,
                      int warm, int resident, void* stream) {
  if (resident)
    return launch_sweep<double, true>(a, b, c_stack, scratch, feas, obj, x, status, iters,
                                      bsz, steps, m, n, cap, rule, seed, tol, warm, stream);
  return launch_sweep<double, false>(a, b, c_stack, scratch, feas, obj, x, status, iters,
                                     bsz, steps, m, n, cap, rule, seed, tol, warm, stream);
}

// Dynamic shared memory of one CTA of the resident variant (bytes).
long long revised_resident_smem(int m, int n, int item) {
  return (long long)resident_smem(m, n, (size_t)item);
}

// Resident CTAs an SM of the resident solve kernel at `smem` bytes a CTA.
int revised_resident_occupancy(int item, long long smem) {
  return item == 8 ? resident_blocks<double>(revised_kernel<double, true>, (size_t)smem)
                   : resident_blocks<float>(revised_kernel<float, true>, (size_t)smem);
}

const char* revised_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
