// Two-phase tableau simplex for Hopper (sm_90a), in two variants.
//
// Replaces: src/repro/kernels/simplex_pallas.py:_kernel (the Pallas TPU
// kernel that runs the whole two-phase loop over a VMEM tile of LPs through
// the blocks of src/repro/core/engine.py).
//
// What bounds it on this card: the rank-1 pivot sweep.  Each pivot reads and
// writes the whole (m+1) x q tableau of the LP once and does 2 flops per
// entry, about 0.25 flop per byte.  A tableau that lives in global memory is
// bound by memory bandwidth and by the block-wide barriers between the
// phases of a step, not by the FP32 rate; one that lives in shared memory is
// bound by the shared-memory sweep and the barriers.
//
// The cluster variant (simplex_cluster_kernel, the main paths): one LP is one
// thread-block cluster of k CTAs (kernels/cluster.py:plan_simplex picks the
// least k whose shared memory holds the tableau: 1 for the paper's type 1,
// 2 for type 2, 10 for a 500 x 500 crossover tile).
//  * CTA r holds a contiguous band of the constraint rows, its basis entries
//    and its own copy of the objective row in shared memory for the whole
//    solve: loaded once with cp.async, written back at the end, so a resume
//    is the same launch;
//  * every CTA prices its own copy of the objective row (select_entering,
//    RPC noise included) and applies the same rank-1 update to it with the
//    same operands, so the copies keep the same bits and every CTA takes the
//    same entering column without an exchange;
//  * the ratio test runs on each band; the k (value, row) winners are
//    combined over distributed shared memory in rank order with
//    common.cuh:better, a total order with lowest-index ties, so the winner
//    is the one-block winner whatever the grouping;
//  * the owner of the pivot row writes the normalised row, the other CTAs
//    copy it over DSMEM (the next pivot's barrier comes before the owner may
//    overwrite it), and each CTA sweeps its band and its objective row in
//    shared memory, a warp per row, with no division per entry;
//  * what sums over all rows once per LP (the phase-I value, the phase-II
//    objective row, the extraction of x) reads the other bands over DSMEM in
//    strictly ascending row order, as the one-block loop does.
//  Two cluster barriers a pivot (block barriers when k = 1); no atomics.
//
// The global variant (simplex_kernel, tableaus past the largest cluster):
// one CTA per LP, the tableau updated in place in global memory, the sweep
// flat over (m+1)*q entries, the pivot column and normalised row staged in
// shared memory.
//
// Determinism contract (both variants bit-identical to the plain PyTorch
// version on the card): every multiply, add, subtract and divide is a
// separately rounded IEEE operation (__fmul_rn & co., and the library is
// built -fmad=false); the phase-II pricing and the phase-I value sum over the
// rows in ascending order; every arg-reduction breaks ties toward the lowest
// index; tol and BIG are compared in the tableau's type.  Each CTA loops on
// its own LP while step < cap and the LP is RUNNING: a finished LP is frozen
// in the lockstep plain version, and the RPC counter is the LP's own loop
// index, so results are the same.

#include "cluster.cuh"
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
      t[k] = i == l ? npr[j] : A::fms(t[k], col[i], npr[j]);
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

// Dynamic shared memory of one CTA of the cluster variant: the band (mb rows
// of q), the objective row copy, the normalised pivot row and the band's
// pivot column, then the band's basis entries.  kernels/cluster.py mirrors it.
__host__ __device__ inline size_t cluster_smem(int m, int q, int k, size_t item) {
  const size_t mb = (size_t)((m + k - 1) / k);
  return item * (mb * q + 2 * (size_t)q + mb + 1) + sizeof(int) * mb;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
simplex_cluster_kernel(T* __restrict__ tab, int* __restrict__ basis, int* __restrict__ phase_io,
                       const T* __restrict__ c_ext, const T* __restrict__ feas,
                       T* __restrict__ obj_out, T* __restrict__ x_out,
                       int* __restrict__ status_out, int* __restrict__ iters_out, int m, int n,
                       int q, int art_start, int cap, int rule, uint32_t seed, uint32_t row0,
                       T tol, int k) {
  using A = Arith<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long lp = blockIdx.x / k;
  const int mb = (m + k - 1) / k;
  const int r0 = min(m, rank * mb), r1 = min(m, r0 + mb), rows = r1 - r0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* band = reinterpret_cast<T*>(smem_raw);  // rows r0..r1-1, q values each
  T* obj = band + (size_t)mb * q;            // this CTA's copy of row m
  T* npr = obj + q;                          // normalised pivot row (and staging)
  T* col = npr + q;                          // the band's pivot column
  int* bas = reinterpret_cast<int*>(col + mb + 1);
  __shared__ T red_v[WARPS + 1];
  __shared__ int red_i[WARPS + 1];
  __shared__ T win_v[MAX_CLUSTER];
  __shared__ int win_i[MAX_CLUSTER];
  __shared__ T my_v;  // this CTA's ratio-test winner, read by the cluster
  __shared__ int my_i;
  __shared__ T sh_z;

  T* t = tab + lp * (long long)(m + 1) * q;
  int* gbas = basis + lp * (long long)m;
  const T* ce = c_ext + lp * (long long)q;
  copy_async(band, t + (long long)r0 * q, (long long)rows * q);
  copy_async(obj, t + (long long)m * q, (long long)q);
  for (int i = tid; i < rows; i += THREADS) bas[i] = gbas[r0 + i];
  __pipeline_wait_prior(0);
  __syncthreads();

  const T big = static_cast<T>(1e30);
  const T half_big = static_cast<T>(5e29);
  const T feas_tol = feas[lp];
  int phase = phase_io[lp];
  int status = RUNNING;
  int iters = 0;

  for (int step = 0; step < cap; ++step) {
    // ---- pricing on this CTA's copy of the objective row (the same bits in
    // every CTA, so the same entering column).
    T max_c;
    int e;
    select_entering<T>(obj, q, 1 + n + m, rule, tol, seed, (uint32_t)step, row0 + (uint32_t)lp,
                       red_v, red_i, max_c, e);

    if (max_c <= tol) {
      if (phase == 2) { status = OPTIMAL; break; }
      // Every band is final for this step; npr is free (its readers have
      // swept since).
      sync_cluster(cluster, k);
      // Phase-I value: the basic artificials summed in ascending row order,
      // staged from every band into npr (q > m) and summed by one thread.
      for (int i = tid; i < m; i += THREADS) {
        const int src = i / mb, li = i - src * mb;
        const T* rb = cluster.map_shared_rank(band, src);
        const int* rbas = cluster.map_shared_rank(bas, src);
        npr[i] = rbas[li] >= art_start ? rb[(size_t)li * q] : T(0);
      }
      __syncthreads();
      if (tid == 0) {
        T z = T(0);
        for (int i = 0; i < m; ++i) z = A::add(z, npr[i]);
        sh_z = z;
      }
      __syncthreads();
      if (!(sh_z <= feas_tol)) { status = INFEASIBLE; break; }
      // Enter phase II: objective row = c_ext - sum_i c_B[i] * row_i, rows
      // summed in ascending order; CTA r computes a slice of the columns
      // and the cluster exchanges the slices.
      const int qc = (q + k - 1) / k;
      const int j0 = min(q, rank * qc), j1 = min(q, j0 + qc);
      for (int j = j0 + tid; j < j1; j += THREADS) {
        T acc = T(0);
        for (int src = 0; src < k; ++src) {
          const int s0 = min(m, src * mb), s1 = min(m, s0 + mb);
          const T* rb = cluster.map_shared_rank(band, src);
          const int* rbas = cluster.map_shared_rank(bas, src);
          for (int li = 0; li < s1 - s0; ++li) {
            const int b = rbas[li];
            const T cb = ce[b < q ? b : q - 1];
            acc = A::add(acc, A::mul(cb, rb[(size_t)li * q + j]));
          }
        }
        obj[j] = A::sub(ce[j], acc);
      }
      sync_cluster(cluster, k);
      for (int src = 0; src < k; ++src) {
        if (src == rank) continue;
        const int s0 = min(q, src * qc), s1 = min(q, s0 + qc);
        const T* ro = cluster.map_shared_rank(obj, src);
        for (int j = s0 + tid; j < s1; j += THREADS) obj[j] = ro[j];
      }
      phase = 2;
      __syncthreads();
      continue;
    }

    // ---- ratio test on the band, then the cluster's winner.
    for (int li = tid; li < rows; li += THREADS) col[li] = band[(size_t)li * q + e];
    T rv = static_cast<T>(INFINITY);
    int ri = INT_MAX;
    for (int li = tid; li < rows; li += THREADS) {
      const T c = col[li];
      const T rhs = band[(size_t)li * q];
      T r = c > tol ? A::div(rhs, c) : big;
      if (bas[li] >= art_start && rhs <= tol && c < -tol) r = T(0);
      if (better<T, false>(r, r0 + li, rv, ri)) { rv = r; ri = r0 + li; }
    }
    T min_ratio;
    int l;
    block_arg<T, false>(rv, ri, red_v, red_i, min_ratio, l);
    if (k > 1) {  // a cluster of one has its winner
      if (tid == 0) {
        my_v = min_ratio;
        my_i = l;
      }
      cluster.sync();  // A: every band's winner published
      if (tid < k) {
        win_v[tid] = *cluster.map_shared_rank(&my_v, tid);
        win_i[tid] = *cluster.map_shared_rank(&my_i, tid);
      }
      __syncthreads();
      min_ratio = static_cast<T>(INFINITY);
      l = INT_MAX;
      for (int src = 0; src < k; ++src)
        if (better<T, false>(win_v[src], win_i[src], min_ratio, l)) {
          min_ratio = win_v[src];
          l = win_i[src];
        }
    }
    if (min_ratio >= half_big) { status = UNBOUNDED; break; }

    // ---- pivot: the owner of row l normalises it, the others copy it.
    const int owner = l / mb;
    const int ll = l - r0;
    if (rank == owner) {
      const T pe = col[ll];
      const T pe_safe = fabs(pe) > tol ? pe : T(1);
      for (int j = tid; j < q; j += THREADS) npr[j] = A::div(band[(size_t)ll * q + j], pe_safe);
    }
    const T col_obj = obj[e];
    sync_cluster(cluster, k);  // B: the normalised row is ready in the owner
    if (rank != owner) {
      const T* rn = cluster.map_shared_rank(npr, owner);
      for (int j = tid; j < q; j += THREADS) npr[j] = rn[j];
      __syncthreads();
    }
    // ---- the rank-1 sweep of the band (a warp per row) and of the
    // objective row copy.
    for (int li = warp; li < rows; li += WARPS) {
      T* row = band + (size_t)li * q;
      if (li == ll) {
        for (int j = lane; j < q; j += 32) row[j] = npr[j];
      } else {
        const T ci = col[li];
        for (int j = lane; j < q; j += 32) row[j] = A::fms(row[j], ci, npr[j]);
      }
    }
    for (int j = tid; j < q; j += THREADS) obj[j] = A::fms(obj[j], col_obj, npr[j]);
    if (tid == 0 && rank == owner) bas[ll] = e;
    ++iters;
    __syncthreads();
  }
  if (status == RUNNING) status = ITER_LIMIT;
  sync_cluster(cluster, k);  // every band final

  // ---- extraction: x_j = rhs of the row where x_j is basic, rows ascending,
  // the columns split across the cluster.
  const bool ok = status == OPTIMAL;
  const int nc = (n + k - 1) / k;
  const int x0 = min(n, rank * nc), x1 = min(n, x0 + nc);
  for (int j = x0 + tid; j < x1; j += THREADS) {
    T acc = T(0);
    for (int src = 0; src < k; ++src) {
      const int s0 = min(m, src * mb), s1 = min(m, s0 + mb);
      const T* rb = cluster.map_shared_rank(band, src);
      const int* rbas = cluster.map_shared_rank(bas, src);
      for (int li = 0; li < s1 - s0; ++li)
        acc = A::add(acc, rbas[li] == j + 1 ? rb[(size_t)li * q] : T(0));
    }
    x_out[lp * (long long)n + j] = ok ? acc : T(0);
  }
  // ---- the terminal state back to the caller's buffers.
  T* gband = t + (long long)r0 * q;
  for (long long idx = tid; idx < (long long)rows * q; idx += THREADS) gband[idx] = band[idx];
  for (int i = tid; i < rows; i += THREADS) gbas[r0 + i] = bas[i];
  if (rank == 0) {
    for (int j = tid; j < q; j += THREADS) t[(long long)m * q + j] = obj[j];
    if (tid == 0) {
      obj_out[lp] = ok ? -obj[0] : -static_cast<T>(INFINITY);
      status_out[lp] = status;
      iters_out[lp] = iters;
      phase_io[lp] = phase;
    }
  }
  sync_cluster(cluster, k);  // no CTA leaves while another reads its shared memory
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

template <typename T>
int launch_cluster_variant(void* tab, void* basis, void* phase, const void* c_ext,
                           const void* feas, void* obj, void* x, void* status, void* iters,
                           int bsz, int m, int n, int q, int art_start, int cap, int rule,
                           unsigned seed, unsigned row0, double tol, int k, void* stream) {
  if (bsz <= 0) return 0;
  return (int)launch_cluster(simplex_cluster_kernel<T>, bsz, k, THREADS,
                             cluster_smem(m, q, k, sizeof(T)), (cudaStream_t)stream, (T*)tab,
                             (int*)basis, (int*)phase, (const T*)c_ext, (const T*)feas, (T*)obj,
                             (T*)x, (int*)status, (int*)iters, m, n, q, art_start, cap, rule,
                             (uint32_t)seed, (uint32_t)row0, static_cast<T>(tol), k);
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

int simplex_cluster_f32(void* tab, void* basis, void* phase, const void* c_ext, const void* feas,
                        void* obj, void* x, void* status, void* iters, int bsz, int m, int n,
                        int q, int art_start, int cap, int rule, unsigned seed, unsigned row0,
                        double tol, int k, void* stream) {
  return launch_cluster_variant<float>(tab, basis, phase, c_ext, feas, obj, x, status, iters, bsz,
                                       m, n, q, art_start, cap, rule, seed, row0, tol, k, stream);
}

int simplex_cluster_f64(void* tab, void* basis, void* phase, const void* c_ext, const void* feas,
                        void* obj, void* x, void* status, void* iters, int bsz, int m, int n,
                        int q, int art_start, int cap, int rule, unsigned seed, unsigned row0,
                        double tol, int k, void* stream) {
  return launch_cluster_variant<double>(tab, basis, phase, c_ext, feas, obj, x, status, iters,
                                        bsz, m, n, q, art_start, cap, rule, seed, row0, tol, k,
                                        stream);
}

// Dynamic shared memory of one CTA of the cluster variant (bytes).
long long simplex_cluster_smem(int m, int q, int k, int item) {
  return (long long)cluster_smem(m, q, k, (size_t)item);
}

// cudaOccupancyMaxActiveClusters of the cluster variant at k CTAs and `smem`
// bytes; a negative value is a CUDA error code.
int simplex_cluster_occupancy(int item, int k, long long smem) {
  return item == 8 ? active_clusters(simplex_cluster_kernel<double>, k, THREADS, (size_t)smem)
                   : active_clusters(simplex_cluster_kernel<float>, k, THREADS, (size_t)smem);
}

const char* simplex_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
