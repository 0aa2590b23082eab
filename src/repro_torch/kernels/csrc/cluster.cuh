// Pieces shared by the cluster variants of the simplex and PDHG kernels
// (simplex.cu, pdhg.cu): the shared-memory budget (also the resident revised
// kernel's, revised.cu), the asynchronous copy of an LP's slice into shared
// memory, the cluster launch and the occupancy query.  One LP is one
// thread-block cluster of k CTAs on neighbouring SMs; each CTA holds a slice
// of the LP's data in its shared memory for the whole solve, and the CTAs
// read each other's slices through distributed shared memory
// (cooperative_groups::this_cluster(), map_shared_rank).
//
// The Python side (kernels/cluster.py) mirrors SMEM_LIMIT, STATIC_RESERVE and
// MAX_CLUSTER and each kernel's layout arithmetic (the *_cluster_smem exports
// let a run on the card hold the two against each other).
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_kernels {

namespace cg = cooperative_groups;

// Shared memory one block may hold on Hopper (sharedMemPerBlockOptin), the
// static shared memory a cluster kernel may declare beside its dynamic
// buffer, and the largest cluster the hardware schedules (above 8 only with
// cudaFuncAttributeNonPortableClusterSizeAllowed).
constexpr int SMEM_LIMIT = 232448;
constexpr int STATIC_RESERVE = 2048;
constexpr int MAX_CLUSTER = 16;

// Issue cp.async copies of `count` elements from global to shared memory and
// commit them as one group: 16-byte chunks where the two addresses agree mod
// 16, element copies at the ragged ends or where they do not.  The caller
// waits with __pipeline_wait_prior(0) and a barrier.
template <typename T>
__device__ void copy_async(T* dst, const T* src, long long count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  constexpr long long per = 16 / sizeof(T);
  long long head = count, chunks = 0;
  if (((da ^ sa) & 15) == 0) {
    head = (long long)(((16 - (sa & 15)) & 15) / sizeof(T));
    if (head > count) head = count;
    chunks = (count - head) / per;
  }
  const long long body_end = head + chunks * per;
  for (long long i = tid; i < chunks; i += nt)
    __pipeline_memcpy_async(dst + head + i * per, src + head + i * per, 16);
  for (long long i = tid; i < head; i += nt) __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  for (long long i = body_end + tid; i < count; i += nt)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  __pipeline_commit();
}

// A barrier over the cluster (release/acquire at cluster scope, so the CTAs
// see each other's shared-memory writes); a block barrier when the cluster is
// one CTA.
__device__ __forceinline__ void sync_cluster(const cg::cluster_group& cluster, int k) {
  if (k > 1)
    cluster.sync();
  else
    __syncthreads();
}

// The attributes a launch of `kernel` in clusters of k CTAs with `smem` bytes
// of dynamic shared memory needs.  Refuses (cudaErrorInvalidValue) a k outside
// 1..MAX_CLUSTER, a kernel whose static shared memory exceeds STATIC_RESERVE,
// and a total above SMEM_LIMIT.
template <typename Kernel>
cudaError_t prepare_cluster(Kernel kernel, int k, size_t smem) {
  if (k < 1 || k > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (fa.sharedSizeBytes > (size_t)STATIC_RESERVE || smem + fa.sharedSizeBytes > (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

inline cudaLaunchConfig_t cluster_config(int clusters, int k, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)k, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of `clusters` clusters of k CTAs (cudaLaunchKernelEx).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int clusters, int k, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = prepare_cluster(kernel, k, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(clusters, k, threads, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for clusters of k CTAs with `smem` bytes of
// dynamic shared memory: how many such clusters the device holds at once
// (0: it cannot schedule one).  A negative value is a CUDA error code.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), int k, int threads, size_t smem) {
  cudaError_t err = prepare_cluster(kernel, k, smem);
  if (err == cudaErrorInvalidValue) {
    cudaGetLastError();
    return 0;
  }
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, k, threads, smem, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err == cudaErrorInvalidClusterSize || err == cudaErrorInvalidValue ? 0 : -(int)err;
  }
  return clusters;
}

}  // namespace repro_kernels
