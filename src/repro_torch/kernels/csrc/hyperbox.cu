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
// What the design does about it: each CTA takes a tile of R consecutive rows
// (R <= 256, as many as a 48 KB stage holds), so the tile's d, lo and hi are
// three contiguous ranges of R*n elements whatever n is.  The CTA streams
// them into shared memory with 16-byte cp.async copies, every thread issuing
// its share of all three ranges before one wait (a scalar head and tail
// where a range does not start or end on 16 bytes; the shared copy is
// shifted to the source's alignment, so an offset view streams as fast), and
// several CTAs an SM keep more bytes in flight.  Then one thread a row
// reduces its row from shared memory in ascending j and writes one value.
// lo and hi take a row stride; a stride of 0 serves one box shared by every
// direction, staged once per CTA.  A row too long for the stage is reduced
// by one CTA in column chunks.  Products and the running sum are formed in
// double (exact products of two floats), so the float32 result is one
// rounding of the sum; the plain version's sum order differs, so the two
// agree to a tolerance.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE_BYTES = 48 * 1024;

// Elements of alignment room before each staged range.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

// Stage `count` elements of src into shared memory at dst_base (16-byte
// aligned, with pad<T>() elements of room), shifted so that the shared copy
// and src agree mod 16: a scalar head, 16-byte chunks, a scalar tail, all
// with cp.async.  Returns where element 0 landed.  The caller commits.
template <typename T>
__device__ T* stage(T* dst_base, const T* src, long long count) {
  constexpr int per = pad<T>();
  const int tid = threadIdx.x;
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  T* dst = dst_base + shift;
  const long long head = min((long long)((per - shift) % per), count);
  const long long chunks = (count - head) / per;
  const long long tail = head + chunks * per;
  for (long long i = tid; i < chunks; i += THREADS)
    __pipeline_memcpy_async(dst + head + i * per, src + head + i * per, 16);
  for (long long i = tid; i < head; i += THREADS)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  for (long long i = tail + tid; i < count; i += THREADS)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  return dst;
}

// Elements a staged range of `count` takes in shared memory: room for the
// shift, rounded to 16 bytes so that the next range starts aligned.
template <typename T>
__host__ __device__ inline long long region(long long count) {
  constexpr int per = pad<T>();
  return (count + per - 1) / per * per + per;
}

// Rows a tile, and columns a chunk, for rows of n with `per_row` of the
// three arrays strided by row (the others are one shared box).  A tile of
// full rows where one fits the stage, else one row in column chunks.
template <typename T>
__host__ __device__ inline void tiling(int n, int per_row, int& rows, int& chunk) {
  const long long room = STAGE_BYTES / (int)sizeof(T) - 6 * pad<T>();
  const long long fixed = (long long)(3 - per_row) * n;
  const long long fit = (room - fixed) / ((long long)per_row * n);
  if (fit >= 1) {
    rows = (int)(fit < THREADS ? fit : THREADS);
    if (rows >= 32) rows -= rows % 32;
    chunk = n;
  } else {
    rows = 1;
    chunk = (int)(room / 3);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hyperbox_kernel(const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ d,
                T* __restrict__ out, long long bsz, int n, long long lo_stride,
                long long hi_stride, int tile_rows, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, bsz - r0);
  const int lo_rows = lo_stride ? tile_rows : 1;
  T* d_base = reinterpret_cast<T*>(smem_raw);
  T* lo_base = d_base + region<T>((long long)tile_rows * chunk);
  T* hi_base = lo_base + region<T>((long long)lo_rows * chunk);
  const bool whole = chunk >= n;  // else one row in column chunks
  double acc = 0.0;                // that row's running sum
  for (int j0 = 0; j0 < n; j0 += chunk) {
    // rows == 1 or cols == n, so each range is contiguous.
    const int cols = min(chunk, n - j0);
    const long long count = (long long)rows * cols;
    const T* sd = stage(d_base, d + r0 * n + j0, count);
    const T* sl = stage(lo_base, lo + r0 * lo_stride + j0, lo_stride ? count : cols);
    const T* sh = stage(hi_base, hi + r0 * hi_stride + j0, hi_stride ? count : cols);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (tid < rows) {
      const T* dr = sd + (size_t)tid * cols;
      const T* lr = sl + (lo_stride ? (size_t)tid * cols : 0);
      const T* hr = sh + (hi_stride ? (size_t)tid * cols : 0);
      double sum = whole ? 0.0 : acc;
      for (int j = 0; j < cols; ++j) {
        const T dj = dr[j];
        const T p = dj < T(0) ? lr[j] : hr[j];
        sum = sum + (double)dj * (double)p;
      }
      if (whole) out[r0 + tid] = static_cast<T>(sum);
      else acc = sum;
    }
    __syncthreads();  // the stage is read before the next chunk overwrites it
  }
  if (!whole && tid == 0) out[r0] = static_cast<T>(acc);
}

template <typename T>
int launch(const void* lo, const void* hi, const void* d, void* out, long long bsz, int n,
           long long lo_stride, long long hi_stride, void* stream) {
  if (bsz <= 0) return 0;
  if (n <= 0) return (int)cudaMemsetAsync(out, 0, sizeof(T) * bsz, (cudaStream_t)stream);
  int rows, chunk;
  tiling<T>(n, 1 + (lo_stride != 0) + (hi_stride != 0), rows, chunk);
  const size_t smem = sizeof(T) * (size_t)(region<T>((long long)rows * chunk) +
                                           region<T>((long long)(lo_stride ? rows : 1) * chunk) +
                                           region<T>((long long)(hi_stride ? rows : 1) * chunk));
  const long long blocks = (bsz + rows - 1) / rows;
  hyperbox_kernel<T><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)lo, (const T*)hi, (const T*)d, (T*)out, bsz, n, lo_stride, hi_stride, rows,
      chunk);
  return (int)cudaGetLastError();
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
