// Closed-form hyperbox LP (support function), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hyperbox_pallas.py:_kernel, which streams
// (lo, hi, d) tiles through VMEM and row-reduces
// sum_i d_i * (d_i < 0 ? lo_i : hi_i).
//
// What bounds it on this card: bytes.  Two flops per 12 (float) or 24
// (double) bytes read, far below the card's flop-per-byte balance, so the
// least time is the bytes of lo, hi and d read once plus the output written
// once, over the memory rate.
//
// What the design does about it: a group of TPR neighbouring lanes
// (TPR = the largest power of two <= n, at most 32) owns one row, so a warp
// reads 32 neighbouring floats per load (coalesced) and no lane is idle for
// n >= TPR; the group sums its strided partial products and reduces them
// with shuffles.  lo and hi take a row stride, and a stride of 0 serves one
// box shared by every direction without materialising it.  Every multiply
// and add is a separately rounded operation (built -fmad=false); the
// reduction order differs from torch.sum, so it is held to a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
hyperbox_kernel(const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ d,
                T* __restrict__ out, long long bsz, int n, long long lo_stride,
                long long hi_stride) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = g / TPR;
  const int lane = (int)(g % TPR);
  T acc = T(0);
  if (row < bsz) {
    const T* dr = d + row * n;
    const T* lr = lo + row * lo_stride;
    const T* hr = hi + row * hi_stride;
    for (int j = lane; j < n; j += TPR) {
      const T dj = dr[j];
      const T p = dj < T(0) ? lr[j] : hr[j];
      acc = acc + dj * p;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc = acc + __shfl_down_sync(0xffffffffu, acc, off, TPR);
  if (row < bsz && lane == 0) out[row] = acc;
}

template <typename T, int TPR>
int launch_tpr(const void* lo, const void* hi, const void* d, void* out, long long bsz, int n,
               long long lo_stride, long long hi_stride, cudaStream_t stream) {
  const long long threads = bsz * TPR;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  hyperbox_kernel<T, TPR><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)lo, (const T*)hi, (const T*)d, (T*)out, bsz, n, lo_stride, hi_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* lo, const void* hi, const void* d, void* out, long long bsz, int n,
           long long lo_stride, long long hi_stride, void* stream_ptr) {
  if (bsz <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n >= 32) return launch_tpr<T, 32>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
  if (n >= 16) return launch_tpr<T, 16>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
  if (n >= 8) return launch_tpr<T, 8>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
  if (n >= 4) return launch_tpr<T, 4>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
  if (n >= 2) return launch_tpr<T, 2>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
  return launch_tpr<T, 1>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
}

}  // namespace

extern "C" {

int hyperbox_f32(const void* lo, const void* hi, const void* d, void* out, long long bsz, int n,
                 long long lo_stride, long long hi_stride, void* stream) {
  return launch<float>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
}

int hyperbox_f64(const void* lo, const void* hi, const void* d, void* out, long long bsz, int n,
                 long long lo_stride, long long hi_stride, void* stream) {
  return launch<double>(lo, hi, d, out, bsz, n, lo_stride, hi_stride, stream);
}

const char* hyperbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
