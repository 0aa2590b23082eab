// Pieces shared by the simplex kernels (simplex.cu, revised.cu): status and
// rule codes, separately rounded arithmetic, the RPC noise hash and the
// block-wide arg-reductions with lowest-index ties.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace repro_kernels {

constexpr int RUNNING = 0;
constexpr int OPTIMAL = 1;
constexpr int UNBOUNDED = 2;
constexpr int INFEASIBLE = 3;
constexpr int ITER_LIMIT = 4;

constexpr int RULE_LPC = 0;
constexpr int RULE_RPC = 1;
constexpr int RULE_BLAND = 2;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Every multiply, add, subtract and divide as one IEEE-rounded operation
// (the library is also built -fmad=false), as the plain PyTorch versions
// compute them.  fms(a, b, c) = a - b * c is the tableau's rank-1 update:
// in float it takes the float64 route of core/engine.py:rank1_update (the
// product is exact in double, the difference rounds once there and once to
// float), which follows the reference's contracted update; in double it is
// one multiply and one subtract.
template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fms(float a, float b, float c) {
    return __double2float_rn(__dsub_rn((double)a, __dmul_rn((double)b, (double)c)));
  }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fms(double a, double b, double c) {
    return __dsub_rn(a, __dmul_rn(b, c));
  }
};

// lowbias32 finalizer, as src/repro/core/engine.py:_mix32.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// RPC noise for (seed, step, global row, column): the top 24 bits of the
// hash as a float in [0, 1), exact in float and double.
template <typename T>
__device__ __forceinline__ T rpc_noise(uint32_t seed, uint32_t step, uint32_t row,
                                       uint32_t col) {
  const uint32_t key = seed * 0x9E3779B9u;
  const uint32_t ctr = step * 0x85EBCA6Bu;
  const uint32_t x = mix32((row * 0xC2B2AE35u) ^ col ^ key ^ ctr);
  return Arith<T>::mul(static_cast<T>(x >> 8), static_cast<T>(1.0 / 16777216.0));
}

// Total order of (value, index) pairs: for MAX the larger value wins, for
// MIN the smaller; a NaN wins over any number (torch.argmax/argmin treat
// NaN as the extreme); equal values go to the lower index.
template <typename T, bool MAX>
__device__ __forceinline__ bool better(T av, int ai, T bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  if (MAX ? av > bv : av < bv) return true;
  return av == bv && ai < bi;
}

template <typename T, bool MAX>
__device__ __forceinline__ void warp_arg(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better<T, MAX>(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide arg-reduction; every thread gets the winner.  sv/si hold
// WARPS + 1 slots.  Ends with a barrier so the scratch can be reused.
template <typename T, bool MAX>
__device__ void block_arg(T v, int i, T* sv, int* si, T& out_v, int& out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_arg<T, MAX>(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? sv[lane] : (MAX ? -static_cast<T>(INFINITY) : static_cast<T>(INFINITY));
    i = lane < WARPS ? si[lane] : INT_MAX;
    warp_arg<T, MAX>(v, i);
    if (lane == 0) {
      sv[WARPS] = v;
      si[WARPS] = i;
    }
  }
  __syncthreads();
  out_v = sv[WARPS];
  out_i = si[WARPS];
  __syncthreads();
}

// Entering column over the objective row obj[0..q): columns 1..q_elig-1 may
// enter.  LPC takes the largest reduced cost; Bland the first eligible one
// above tol (column 0 when none is); RPC the eligible one above tol with the
// largest noise.  Returns the largest eligible reduced cost in max_c.
template <typename T>
__device__ void select_entering(const T* obj, int q, int q_elig, int rule, T tol, uint32_t seed,
                                uint32_t step, uint32_t row, T* sv, int* si, T& max_c, int& e) {
  const T big = static_cast<T>(1e30);
  T v1 = -static_cast<T>(INFINITY), v2 = -static_cast<T>(INFINITY);
  int i1 = INT_MAX, i2 = INT_MAX;
  for (int j = threadIdx.x; j < q; j += THREADS) {
    const bool elig = j >= 1 && j < q_elig;
    const T r = obj[j];
    const T cand = elig ? r : -big;
    if (better<T, true>(cand, j, v1, i1)) { v1 = cand; i1 = j; }
    if (rule != RULE_LPC) {
      const bool pos = elig && r > tol;
      T w;
      if (rule == RULE_BLAND) w = pos ? T(1) : T(0);
      else w = pos ? rpc_noise<T>(seed, step, row, (uint32_t)j) : -big;
      if (better<T, true>(w, j, v2, i2)) { v2 = w; i2 = j; }
    }
  }
  block_arg<T, true>(v1, i1, sv, si, max_c, e);
  if (rule != RULE_LPC) {
    T unused;
    block_arg<T, true>(v2, i2, sv, si, unused, e);
  }
}

}  // namespace repro_kernels
