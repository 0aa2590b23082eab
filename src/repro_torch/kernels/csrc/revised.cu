// Shared-A revised simplex, one thread block per LP, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/revised_pallas.py:_kernel (the Pallas TPU
// kernel that runs src/repro/core/revised.py:iteration_step and finalize over
// a VMEM tile of LPs against one VMEM-resident A).
//
// The function, per LP and step: the basic costs c_B under the current phase;
// y = c_B . B^-1 and w = y . sgn; the reduced costs (c or 0) - w . A of the
// originals and -w of the slacks, with the phase-I value -c_B . x_B in slot 0;
// the entering column under lpc/rpc/bland; u = B^-1 . (sgn * column of [A|I]);
// the basic columns' reduced costs set to 0 (as the plain version does: priced
// afresh they are rounding noise that can exceed tol and let a basic column
// enter); the ratio test with the degenerate-artificial escape; and the rank-1
// product-form update of binv and xb around the pivot.  After the loop,
// status ITER_LIMIT for LPs still running and the primal point x.  The
// objective is computed by the wrapper from the terminal (basis, xb).
//
// What bounds it on this card: per pivot about 6 m^2 + 2 m n flops (y, u and
// the binv update are 2 m^2 each, the pricing 2 m n) over a binv that is read
// twice and written once (y, u, update).  At 100x100 in float32 binv is 40 KB
// per LP, the analytic bound (binv read and written once in the whole solve,
// every pivot's flops at the FP32 peak) is compute-bound, and this design
// moves binv through the memory system about four times per pivot.
//
// What the design does about it (simple and right first):
//  * one CTA per LP (blockIdx.x = global LP row, which keys the RPC noise);
//  * A (m x n) is read-only and shared by every CTA, read through the
//    read-only cache; at 100x100 float32 it is 40 KB and stays in L2;
//  * binv, basis, xb and phase are updated in place in the caller's buffers,
//    so the terminal state is the resume state (want_state and a resume are
//    the same launch); basis and xb live in shared memory during the loop;
//  * c_B, y/w, the entering column, u and the normalised pivot row are staged
//    in shared memory; the binv sweep reads u and the pivot row from there,
//    after a barrier, before it overwrites row l;
//  * y_j = sum_i c_B,i binv[i,j] and the pricing sum_i w_i A[i,k] run one
//    thread per output with i ascending: neighbouring threads read
//    neighbouring addresses (coalesced).  u_i = sum_j binv[i,j] me_j runs one
//    thread per row with j ascending: neighbouring threads read addresses m
//    elements apart (uncoalesced; each warp touches 32 cache lines per step of
//    j and relies on L1 to reuse them).  A warp-cooperative u would need a
//    tree order and break bit-identity with the plain version; a layout that
//    keeps binv transposed as well is later perf work;
//  * the type-2 binv (200 x 200 float32 = 160 KB) fits shared memory only at
//    one CTA per SM, so a shared-memory-resident variant is later perf work;
//  * each CTA loops while step < cap and its LP is RUNNING, which equals the
//    reference's lockstep loop: a finished LP is frozen there, and the RPC
//    counter is the LP's own loop index.
//
// Determinism contract (bit-identical to the plain PyTorch version,
// src/repro_torch/core/revised.py, on the card): every multiply, add,
// subtract and divide is a separately rounded IEEE operation (__fmul_rn & co.,
// and the library is built -fmad=false); every contraction sums its inner
// index in ascending order from 0; the entering and leaving reductions break
// ties toward the lowest index; tol and BIG are compared in the LP's type.

#include "common.cuh"

namespace {

using namespace repro_kernels;

template <typename T>
__global__ void __launch_bounds__(THREADS)
revised_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ binv, int* __restrict__ basis_io, T* __restrict__ xb_io,
               int* __restrict__ phase_io, const T* __restrict__ feas, T* __restrict__ x_out,
               int* __restrict__ status_out, int* __restrict__ iters_out, int m, int n,
               int cap, int rule, uint32_t seed, uint32_t row0, T tol) {
  using AR = Arith<T>;
  const int q = 1 + n + m;
  const int art_start = 1 + n + m;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sgn = reinterpret_cast<T*>(smem_raw);  // row signs, m
  T* cb = sgn + m;                          // basic costs, m
  T* w = cb + m;                            // y . sgn, m
  T* me = w + m;                            // signed entering column, m
  T* u = me + m;                            // B^-1 . me, m
  T* npr = u + m;                           // normalised pivot row of binv, m
  T* xb = npr + m;                          // basic solution, m
  T* obj = xb + m;                          // objective row, q
  int* bas = reinterpret_cast<int*>(obj + q);  // basis, m
  __shared__ T red_v[WARPS + 1];
  __shared__ int red_i[WARPS + 1];

  const int tid = threadIdx.x;
  const long long lp = blockIdx.x;
  T* bi = binv + lp * (long long)m * m;
  const T* bl = b + lp * (long long)m;
  const T* cl = c + lp * (long long)n;
  const T big = static_cast<T>(1e30);
  const T half_big = static_cast<T>(5e29);
  const T feas_tol = feas[lp];
  const int total = m * m;

  for (int i = tid; i < m; i += THREADS) {
    sgn[i] = bl[i] < T(0) ? T(-1) : T(1);
    xb[i] = xb_io[lp * m + i];
    bas[i] = basis_io[lp * m + i];
  }
  int phase = phase_io[lp];
  int status = RUNNING;
  int iters = 0;
  __syncthreads();

  for (int step = 0; step < cap; ++step) {
    // ---- basic costs under the current phase (-1/-0 on artificials in phase I).
    for (int i = tid; i < m; i += THREADS) {
      const int id = bas[i];
      if (phase == 1) {
        cb[i] = -(id >= art_start ? T(1) : T(0));
      } else {
        const int k = min(max(id - 1, 0), n - 1);
        cb[i] = (id >= 1 && id <= n) ? __ldg(cl + k) : T(0);
      }
    }
    __syncthreads();
    // ---- y_j = sum_i c_B,i binv[i,j] (i ascending), w = y . sgn.
    for (int j = tid; j < m; j += THREADS) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc = AR::add(acc, AR::mul(cb[i], bi[(long long)i * m + j]));
      w[j] = AR::mul(acc, sgn[j]);
    }
    __syncthreads();
    // ---- objective row: [phase-I value, (c or 0) - w . A, -w].
    for (int k = tid; k < n; k += THREADS) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc = AR::add(acc, AR::mul(w[i], __ldg(a + (long long)i * n + k)));
      obj[1 + k] = AR::sub(phase == 1 ? T(0) : __ldg(cl + k), acc);
    }
    for (int i = tid; i < m; i += THREADS) obj[1 + n + i] = -w[i];
    if (tid == 0) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc = AR::add(acc, AR::mul(cb[i], xb[i]));
      obj[0] = -acc;
    }
    __syncthreads();
    // Basic columns price to rounding noise; their reduced cost is 0.
    for (int i = tid; i < m; i += THREADS) {
      const int id = bas[i];
      if (id < q) obj[id] = T(0);
    }
    __syncthreads();

    // ---- entering column.
    T max_c;
    int e;
    select_entering<T>(obj, q, q, rule, tol, seed, (uint32_t)step, row0 + (uint32_t)lp, red_v,
                       red_i, max_c, e);
    if (max_c <= tol) {
      if (phase == 2) { status = OPTIMAL; break; }
      if (!(obj[0] <= feas_tol)) { status = INFEASIBLE; break; }
      phase = 2;  // pricing is recomputed from (basis, phase) next step
      continue;
    }

    // ---- u = B^-1 . (sgn * column e of [A | I]), j ascending per row.
    for (int i = tid; i < m; i += THREADS) {
      T v;
      if (e <= n) v = __ldg(a + (long long)i * n + min(max(e - 1, 0), n - 1));
      else v = i == min(max(e - 1 - n, 0), m - 1) ? T(1) : T(0);
      me[i] = AR::mul(sgn[i], v);
    }
    __syncthreads();
    for (int i = tid; i < m; i += THREADS) {
      const T* row = bi + (long long)i * m;
      T acc = T(0);
      for (int j = 0; j < m; ++j) acc = AR::add(acc, AR::mul(row[j], me[j]));
      u[i] = acc;
    }
    __syncthreads();

    // ---- ratio test with the degenerate-artificial escape.
    T rv = static_cast<T>(INFINITY);
    int ri = INT_MAX;
    for (int i = tid; i < m; i += THREADS) {
      const T ui = u[i], xi = xb[i];
      T r = ui > tol ? AR::div(xi, ui) : big;
      if (bas[i] >= art_start && xi <= tol && ui < -tol) r = T(0);
      if (better<T, false>(r, i, rv, ri)) { rv = r; ri = i; }
    }
    T min_ratio;
    int l;
    block_arg<T, false>(rv, ri, red_v, red_i, min_ratio, l);
    if (min_ratio >= half_big) { status = UNBOUNDED; break; }

    // ---- pivot: stage the normalised row, then the rank-1 sweeps.
    const T pe = u[l];
    const T pe_safe = fabs(pe) > tol ? pe : T(1);
    for (int j = tid; j < m; j += THREADS) npr[j] = AR::div(bi[(long long)l * m + j], pe_safe);
    const T npx = AR::div(xb[l], pe_safe);
    __syncthreads();
    for (int k = tid; k < total; k += THREADS) {
      const int i = k / m;
      const int j = k - i * m;
      bi[k] = i == l ? npr[j] : AR::sub(bi[k], AR::mul(u[i], npr[j]));
    }
    for (int i = tid; i < m; i += THREADS) xb[i] = i == l ? npx : AR::sub(xb[i], AR::mul(u[i], npx));
    if (tid == 0) bas[l] = e;
    ++iters;
    __syncthreads();
  }
  if (status == RUNNING) status = ITER_LIMIT;
  __syncthreads();

  // ---- terminal state and the primal point x_j = xb of the row where x_j is basic.
  const bool ok = status == OPTIMAL;
  for (int j = tid; j < n; j += THREADS) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc = AR::add(acc, bas[i] == j + 1 ? xb[i] : T(0));
    x_out[lp * (long long)n + j] = ok ? acc : T(0);
  }
  for (int i = tid; i < m; i += THREADS) {
    xb_io[lp * m + i] = xb[i];
    basis_io[lp * m + i] = bas[i];
  }
  if (tid == 0) {
    status_out[lp] = status;
    iters_out[lp] = iters;
    phase_io[lp] = phase;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
           void* phase, const void* feas, void* x, void* status, void* iters, int bsz, int m,
           int n, int cap, int rule, unsigned seed, unsigned row0, double tol, void* stream) {
  if (bsz <= 0) return 0;
  const size_t smem = sizeof(T) * (size_t)(7 * m + 1 + n + m) + sizeof(int) * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(revised_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  revised_kernel<T><<<bsz, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)binv, (int*)basis, (T*)xb, (int*)phase,
      (const T*)feas, (T*)x, (int*)status, (int*)iters, m, n, cap, rule, (uint32_t)seed,
      (uint32_t)row0, static_cast<T>(tol));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int revised_f32(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
                void* phase, const void* feas, void* x, void* status, void* iters, int bsz, int m,
                int n, int cap, int rule, unsigned seed, unsigned row0, double tol, void* stream) {
  return launch<float>(a, b, c, binv, basis, xb, phase, feas, x, status, iters, bsz, m, n, cap,
                       rule, seed, row0, tol, stream);
}

int revised_f64(const void* a, const void* b, const void* c, void* binv, void* basis, void* xb,
                void* phase, const void* feas, void* x, void* status, void* iters, int bsz, int m,
                int n, int cap, int rule, unsigned seed, unsigned row0, double tol, void* stream) {
  return launch<double>(a, b, c, binv, basis, xb, phase, feas, x, status, iters, bsz, m, n, cap,
                        rule, seed, row0, tol, stream);
}

const char* revised_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
