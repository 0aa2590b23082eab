// Two-phase tableau simplex, one thread block per LP, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/simplex_pallas.py:_kernel (the Pallas TPU
// kernel that runs the whole two-phase loop over a VMEM tile of LPs through
// the blocks of src/repro/core/engine.py).
//
// What bounds it on this card: the rank-1 pivot sweep.  Each pivot reads and
// writes the whole (m+1) x q tableau of the LP once and does 2 flops per
// entry, about 0.25 flop per byte of device-memory traffic, so a tableau that
// lives in global memory is bound by memory bandwidth and by the block-wide
// barriers between the phases of a step, not by the FP32 rate.  The
// analytic least time (all tableaus read once, every pivot's flops at the
// FP32 peak) is far below what this design reaches.
//
// What the design does about it (paper Sec. 4.3, simple and right first):
//  * one CTA per LP (blockIdx.x = global LP row); the tableau stays in
//    global memory, updated in place in the unpadded (B, m+1, q) buffer the
//    wrapper built, so any shape runs (the type-2 tableau of the paper,
//    201 x 301 floats = 242 KB, is above the 227 KB a block may hold in
//    shared memory) and a resume is the same launch;
//  * the sweep is flat over (m+1)*q entries, so neighbouring threads touch
//    neighbouring addresses (coalesced);
//  * the pivot column (m+1 values) and the normalised pivot row (q values)
//    are staged in shared memory before the sweep, which overwrites them;
//  * each CTA loops on its own while step < cap and its LP is RUNNING and
//    then exits: a finished LP is frozen in the lockstep plain version, and
//    the RPC counter is the LP's own loop index, so results are the same.
//  A shared-memory-resident variant for tableaus that fit is later work.
//
// Determinism contract (bit-identical to the plain PyTorch version on the
// card): every multiply, add, subtract and divide is a separately rounded
// IEEE operation (__fmul_rn & co., and the library is built -fmad=false);
// the phase-II pricing and the phase-I value sum over the rows in ascending
// order; every arg-reduction breaks ties toward the lowest index; tol and
// BIG are compared in the tableau's type.

#include "common.cuh"

namespace {

using namespace repro_kernels;

template <typename T>
__global__ void __launch_bounds__(THREADS)
simplex_kernel(T* __restrict__ tab, int* __restrict__ basis, int* __restrict__ phase_io,
               const T* __restrict__ c_ext, const T* __restrict__ feas,
               T* __restrict__ obj_out, T* __restrict__ x_out, int* __restrict__ status_out,
               int* __restrict__ iters_out, int m, int n, int q, int art_start, int cap,
               int rule, uint32_t seed, uint32_t row0, T tol) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // pivot column, m + 1 values
  T* npr = col + (m + 1);                   // normalised pivot row, q values
  __shared__ T red_v[WARPS + 1];
  __shared__ int red_i[WARPS + 1];

  const int tid = threadIdx.x;
  const long long lp = blockIdx.x;
  T* t = tab + lp * (long long)(m + 1) * q;
  int* bas = basis + lp * (long long)m;
  const T* ce = c_ext + lp * (long long)q;
  T* objrow = t + (long long)m * q;
  const T big = static_cast<T>(1e30);
  const T half_big = static_cast<T>(5e29);
  const T feas_tol = feas[lp];
  const int total = (m + 1) * q;

  int phase = phase_io[lp];
  int status = RUNNING;
  int iters = 0;

  for (int step = 0; step < cap; ++step) {
    // ---- pricing: max eligible reduced cost, and the entering column.
    T max_c;
    int e;
    select_entering<T>(objrow, q, 1 + n + m, rule, tol, seed, (uint32_t)step,
                       row0 + (uint32_t)lp, red_v, red_i, max_c, e);

    if (max_c <= tol) {
      if (phase == 2) { status = OPTIMAL; break; }
      // Phase-I value: the basic artificials summed in ascending row order
      // (-z0 in exact arithmetic, without float32's cancellation residue).
      T z = T(0);
      for (int i = 0; i < m; ++i)
        z = A::add(z, bas[i] >= art_start ? t[(long long)i * q] : T(0));
      if (!(z <= feas_tol)) { status = INFEASIBLE; break; }
      // Enter phase II: objective row = c_ext - sum_i c_B[i] * row_i,
      // rows summed in ascending order.
      for (int j = tid; j < q; j += THREADS) {
        T acc = T(0);
        for (int i = 0; i < m; ++i) {
          const int b = bas[i];
          const T cb = ce[b < q ? b : q - 1];
          acc = A::add(acc, A::mul(cb, t[(long long)i * q + j]));
        }
        objrow[j] = A::sub(ce[j], acc);
      }
      phase = 2;
      __syncthreads();
      continue;
    }

    // ---- ratio test on the staged pivot column.
    for (int i = tid; i <= m; i += THREADS) col[i] = t[(long long)i * q + e];
    __syncthreads();
    T rv = static_cast<T>(INFINITY);
    int ri = INT_MAX;
    for (int i = tid; i < m; i += THREADS) {
      const T c = col[i];
      const T rhs = t[(long long)i * q];
      T r = c > tol ? A::div(rhs, c) : big;
      if (bas[i] >= art_start && rhs <= tol && c < -tol) r = T(0);
      if (better<T, false>(r, i, rv, ri)) { rv = r; ri = i; }
    }
    T min_ratio;
    int l;
    block_arg<T, false>(rv, ri, red_v, red_i, min_ratio, l);
    if (min_ratio >= half_big) { status = UNBOUNDED; break; }

    // ---- pivot: stage the normalised row, then the rank-1 sweep.
    const T pe = col[l];
    const T pe_safe = fabs(pe) > tol ? pe : T(1);
    for (int j = tid; j < q; j += THREADS) npr[j] = A::div(t[(long long)l * q + j], pe_safe);
    __syncthreads();
    for (int k = tid; k < total; k += THREADS) {
      const int i = k / q;
      const int j = k - i * q;
      t[k] = i == l ? npr[j] : A::sub(t[k], A::mul(col[i], npr[j]));
    }
    if (tid == 0) bas[l] = e;
    ++iters;
    __syncthreads();
  }
  if (status == RUNNING) status = ITER_LIMIT;

  // ---- extraction: objective, and x_j = rhs of the row where x_j is basic.
  const bool ok = status == OPTIMAL;
  for (int j = tid; j < n; j += THREADS) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc = A::add(acc, bas[i] == j + 1 ? t[(long long)i * q] : T(0));
    x_out[lp * (long long)n + j] = ok ? acc : T(0);
  }
  if (tid == 0) {
    obj_out[lp] = ok ? -objrow[0] : -static_cast<T>(INFINITY);
    status_out[lp] = status;
    iters_out[lp] = iters;
    phase_io[lp] = phase;
  }
}

template <typename T>
int launch(void* tab, void* basis, void* phase, const void* c_ext, const void* feas, void* obj,
           void* x, void* status, void* iters, int bsz, int m, int n, int q, int art_start,
           int cap, int rule, unsigned seed, unsigned row0, double tol, void* stream) {
  if (bsz <= 0) return 0;
  const size_t smem = sizeof(T) * (size_t)(m + 1 + q);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(simplex_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  simplex_kernel<T><<<bsz, THREADS, smem, (cudaStream_t)stream>>>(
      (T*)tab, (int*)basis, (int*)phase, (const T*)c_ext, (const T*)feas, (T*)obj, (T*)x,
      (int*)status, (int*)iters, m, n, q, art_start, cap, rule, (uint32_t)seed, (uint32_t)row0,
      static_cast<T>(tol));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int simplex_f32(void* tab, void* basis, void* phase, const void* c_ext, const void* feas,
                void* obj, void* x, void* status, void* iters, int bsz, int m, int n, int q,
                int art_start, int cap, int rule, unsigned seed, unsigned row0, double tol,
                void* stream) {
  return launch<float>(tab, basis, phase, c_ext, feas, obj, x, status, iters, bsz, m, n, q,
                       art_start, cap, rule, seed, row0, tol, stream);
}

int simplex_f64(void* tab, void* basis, void* phase, const void* c_ext, const void* feas,
                void* obj, void* x, void* status, void* iters, int bsz, int m, int n, int q,
                int art_start, int cap, int rule, unsigned seed, unsigned row0, double tol,
                void* stream) {
  return launch<double>(tab, basis, phase, c_ext, feas, obj, x, status, iters, bsz, m, n, q,
                        art_start, cap, rule, seed, row0, tol, stream);
}

const char* simplex_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
