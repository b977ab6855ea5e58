// General-gap DP with tracebacks (K7 dp_tb_kernel) for Hopper (sm_90a).
//
// Replaces the TPU package's device DP engine:
//   alignment_algos_tpu/ops/dp_engine.py _dp_forward (:37), a lax.scan over
//     query rows (:121), called by build_forward_jax (:153);
//   alignment_algos_tpu/ops/dp_engine.py _dp_forward_batched (:210), its
//     vmap over n same-shape pairs, called by build_forward_jax_batched.
// It computes the reference recurrence (dpmatrix.h:356-536) over the
// rectangle (q0, q1, t0, t1) with the traceback pointers every enumerator
// walks: H (float32) and PQ, PT (int32), each (n, q2, t2).
//
// Recurrence, per pair p (all float32; clamp(x) = max(0, x) when local):
//   every cell the build does not set: H = 0, PQ = PT = -1 (NULL);
//   row q0+1:    H[q0+1, t0+1] = clamp(0 + S[q0+1, t0+1]),
//                H[q0+1, j] = clamp((0 - D[t0, j]) + S[q0+1, j]), j <= t1-1;
//   col t0+1:    H[i, t0+1] = clamp((0 - ins0[i]) + S[i, t0+1]),
//                q0+2 <= i <= q1-1; both point to (q0, t0);
//   interior i in [q0+2, q1-1], j in [t0+2, t1-1], s = S[i, j]:
//     match      clamp(H[i-1, j-1] + s)                  -> (i-1, j-1)
//     deletion   clamp((H[i-1, k] - D[k, j]) + s),
//                k = t0+1 .. j-2 ascending               -> (i-1, k)
//     insertion  clamp((H[k, j-1] - Cm[i-k, j]) + s),
//                k = q0+1 .. i-2 ascending               -> (k, j-1)
//   closing (q1, t1): the same three with deletions k in [t0+1, t1-1]
//     against D[k, t1] and insertions k in [q0+1, q1-1] against insc[k].
// Within each gap kind the first maximum wins (ascending k, strict >); then
// match, the deletion maximum and the insertion maximum replace the
// incumbent in that order only when strictly greater (dp_engine.py:102-111,
// :138-147).  Unlike K3, each candidate is rounded and clamped before it is
// compared: fl(x + s) is monotone, so K3's max-then-add gives the right
// value, but two candidates x1 < x2 can round to one fl(x + s), and then
// the first of them is the traceback, not the larger x.  Nothing is
// multiplied here (the host builds Cm, ins0 and insc in the reference's
// multiply-then-add order); the build passes -fmad=false all the same.
//
// Design.  Every cell of row i depends only on rows < i, so the rows run in
// order and all the parallelism is inside a row.  One thread-block cluster
// of C blocks (16 where the card can place it, else 8) takes each pair;
// block b owns the interior columns [cuts[b], cuts[b+1]), cut by the
// wrapper (dp_engine.k7_plan) so that the blocks scan equal numbers of gap
// candidates.  Inside a row, P = 1024 / w threads share each of a block's
// w cells: part p takes the candidates k = start + p, p + P, ...  and keeps
// its first maximum; the parts then meet in a warp per cell (shared memory,
// then __shfl_xor_sync) under the rule "larger value, or an equal value at
// a lower k", which returns the first maximum's k and its value bits (an
// equal -0.0 and +0.0 resolve to the lower k, as the serial scan does).
// Where w > 512 each thread takes whole cells (P = 1).  A finished cell is
// written to H, PQ, PT and into every block's copy of "the row" (distributed
// shared memory, cluster.map_shared_rank); the rows are double-buffered, so
// one cluster barrier per row is enough.  Every value a block reads from
// another block arrives through its shared memory, never through device
// memory (whose L1 copy is not coherent across SMs).
//
// Two memory modes, chosen by the wrapper from the shapes:
//   resident: a block stages its columns of D and Cm in shared memory once
//     (cp.async), and appends row i-1 of its columns' left neighbours (the
//     insertion history H[k, j-1]) from the shared row as it arrives;
//   streamed: D, Cm and the block's own history stay in device memory (rows
//     of D are contiguous in j, so the parts' loads for one k coalesce);
//     the history of the column left of the slice is kept in shared memory.
// The zero / NULL fill, the boundary row and column are split over the
// cluster by columns, each cell written once; the closing cell is reduced
// by the block that owns column t1-1.
//
// What bounds it.  The rows' chain: a cluster barrier and a round of
// distributed-shared stores per row, against an operations bound of a few
// microseconds.  Measured on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 1.48-1.51 ms at 1 x 386 x 404 (about 3.9 us a row) and 0.49-0.52
// ms at 1 x 182 x 224, resident; staging S a row ahead, deferring the
// device-memory stores past the barrier and 512 threads a block each moved
// it by 6% or less, and 8-block clusters made it slower, so the suspect is
// the barrier's wait for the distributed-shared stores (mbarrier-signalled
// st.async rows would replace it: later work).  In the streamed mode, the
// deletion table's bytes, one row of D per candidate k read once per row of
// H through 16 SMs: 61 ms at 1 x 258 x 7,302 with 8 loads in flight per
// thread (303 ms with one).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -3.0e38f;  // dp_engine.NEG
constexpr int kThreads = 1024;    // dp_engine.K7_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kNull = -1;

// block b of a cluster owns the interior columns [cuts[b], cuts[b+1])
struct Cuts {
  int c[kMaxCluster + 1];
};

// max(0, x) when local; -0.0 gives +0.0, as torch.maximum(0, x) does
__device__ __forceinline__ float clampv(float x, int local) {
  return (local && !(x > 0.0f)) ? 0.0f : x;
}

// (v, k) replaces (bv, bk) when larger, or equal at a lower k
__device__ __forceinline__ void take(float v, int k, float& bv, int& bk) {
  if (v > bv || (v == bv && k < bk)) {
    bv = v;
    bk = k;
  }
}

// whether the build sets cell (r, c) (everything else is 0 / NULL)
__device__ __forceinline__ bool set_by_build(int r, int c, int q0, int q1,
                                             int t0, int t1) {
  if (r == q1 && c == t1) return true;
  if (r < q0 + 1 || r > q1 - 1) return false;
  return c >= t0 + 1 && c <= t1 - 1;
}

// The first maximum of clamp((a - b) + s) over k = k0, k0 + step, .. <= k1,
// where load(k, a, b) fetches the operands; the compares run in ascending k
// (strict >).  With kBatch > 1, kBatch candidates' loads are issued before
// any of them is compared, so that they are in flight together (the
// streamed mode's device-memory loads; the resident mode's few shared loads
// per thread run faster unbatched).
template <int kBatch, typename Load>
__device__ __forceinline__ void scan_first_max(int k0, int k1, int step,
                                               float s, int local, Load load,
                                               float& best, int& at) {
  int k = k0;
  for (; kBatch > 1 && k + (kBatch - 1) * step <= k1; k += kBatch * step) {
    float a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) load(k + u * step, a[u], b[u]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float v = clampv((a[u] - b[u]) + s, local);
      if (v > best) {
        best = v;
        at = k + u * step;
      }
    }
  }
#pragma unroll 4
  for (; k <= k1; k += step) {
    float a, b;
    load(k, a, b);
    const float v = clampv((a - b) + s, local);
    if (v > best) {
      best = v;
      at = k;
    }
  }
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Floats of dynamic shared memory a block needs (dp_engine.k7_smem_bytes):
// the two rows, the parts' (value, k) pairs of both gap kinds, then D, Cm
// and the history of its w columns (resident) or the left column's history
// (streamed).
__host__ __device__ inline size_t smem_floats(bool resident, int q2, int t2,
                                              int q0, int q1, int t0,
                                              int c_lo, int c_hi) {
  const int w = c_hi - c_lo;
  const int cm_rows = q1 - q0 - 3 > 0 ? q1 - q0 - 3 : 0;
  const int d_rows = w > 0 && c_hi - 3 - t0 > 0 ? c_hi - 3 - t0 : 0;
  size_t n = 2 * (size_t)t2 + 4 * (size_t)kThreads;
  if (resident) n += (size_t)w * (d_rows + 2 * (size_t)cm_rows);
  else n += q2;
  return n;
}

// S, Cm, H, PQ, PT: (n, q2, t2); D: (n, t2, t2); ins0, insc: (n, q2).
// 0 <= q0, q0 + 2 <= q1 < q2 and the same for t (the wrapper checks).
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    dp_tb_kernel(const float* __restrict__ S, const float* __restrict__ D,
                 const float* __restrict__ Cm,
                 const float* __restrict__ ins0,
                 const float* __restrict__ insc, float* H, int* PQ, int* PT,
                 int q2, int t2, int q0, int q1, int t0, int t1, int local,
                 const Cuts cuts) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t p = blockIdx.x / C;
  const size_t qt = (size_t)q2 * t2;
  S += p * qt;
  Cm += p * qt;
  H += p * qt;
  PQ += p * qt;
  PT += p * qt;
  D += p * (size_t)t2 * t2;
  ins0 += p * q2;
  insc += p * q2;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c_lo = cuts.c[rank], c_hi = cuts.c[rank + 1];
  const int w = c_hi - c_lo;
  const int cm_rows = q1 - q0 - 3 > 0 ? q1 - q0 - 3 : 0;
  const int d_rows = w > 0 && c_hi - 3 - t0 > 0 ? c_hi - 3 - t0 : 0;

  float* rows = smem;  // rows i-1 and i, by column
  float* red_v = rows + 2 * (size_t)t2;
  int* red_k = reinterpret_cast<int*>(red_v + 2 * kThreads);
  float* tail = reinterpret_cast<float*>(red_k + 2 * kThreads);
  float* Dsh = tail;                          // D[t0+1+r, c_lo+jj]
  float* Csh = Dsh + (size_t)d_rows * w;      // Cm[2+r, c_lo+jj]
  float* Hsh = Csh + (size_t)cm_rows * w;     // H[q0+1+r, c_lo-1+jj]
  float* halo = tail;                         // H[k, c_lo-1] (streamed)

  if (kResident && w > 0) {
    for (int c = tid; c < d_rows * w; c += kThreads)
      copy4(Dsh + c, D + (size_t)(t0 + 1 + c / w) * t2 + c_lo + c % w);
    for (int c = tid; c < cm_rows * w; c += kThreads)
      copy4(Csh + c, Cm + (size_t)(2 + c / w) * t2 + c_lo + c % w);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the fill: block 0 also takes the columns left of the interior, the
  // last block those right of it
  {
    const int f_lo = rank == 0 ? 0 : c_lo;
    const int f_hi = rank == C - 1 ? t2 : c_hi;
    const int fw = f_hi - f_lo;
    for (size_t c = tid; c < (size_t)q2 * fw; c += kThreads) {
      const int r = (int)(c / fw), col = f_lo + (int)(c % fw);
      if (!set_by_build(r, col, q0, q1, t0, t1)) {
        const size_t at = (size_t)r * t2 + col;
        H[at] = 0.0f;
        PQ[at] = kNull;
        PT[at] = kNull;
      }
    }
  }

  // boundary row q0+1, whole, into this block's row buffer; its own
  // columns (block 0: and t0+1) to H
  {
    const float* s = S + (size_t)(q0 + 1) * t2;
    const size_t row = (size_t)(q0 + 1) * t2;
    float* buf = rows + (size_t)((q0 + 1) & 1) * t2;
    for (int j = t0 + 1 + tid; j <= t1 - 1; j += kThreads) {
      const float v =
          j == t0 + 1 ? clampv(0.0f + s[j], local)
                      : clampv((0.0f - D[(size_t)t0 * t2 + j]) + s[j], local);
      buf[j] = v;
      if ((j >= c_lo && j < c_hi) || (j == t0 + 1 && rank == 0)) {
        H[row + j] = v;
        PQ[row + j] = q0;
        PT[row + j] = t0;
      }
    }
    if (rank == 0) {
      for (int i = q0 + 2 + tid; i <= q1 - 1; i += kThreads) {
        const size_t c = (size_t)i * t2 + t0 + 1;
        H[c] = clampv((0.0f - ins0[i]) + S[c], local);
        PQ[c] = q0;
        PT[c] = t0;
      }
    }
  }
  if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();  // every block started, staged and holds row q0+1

  const int P = w > 0 ? (kThreads / w > 1 ? kThreads / w : 1) : 1;
  const int part = w > 0 ? tid / w : 0;
  for (int i = q0 + 2; i <= q1 - 1; ++i) {
    const float* hp = rows + (size_t)((i - 1) & 1) * t2;
    float* cur = rows + (size_t)(i & 1) * t2;
    const float* s = S + (size_t)i * t2;
    if (tid == 0)  // the boundary column of row i; no peer writes t0+1
      cur[t0 + 1] = clampv((0.0f - ins0[i]) + s[t0 + 1], local);
    if (w > 0 && i - 1 <= q1 - 3) {  // history for rows i+1 ..
      if (kResident) {
        for (int jj = tid; jj < w; jj += kThreads)
          Hsh[(size_t)(i - 1 - (q0 + 1)) * w + jj] = hp[c_lo - 1 + jj];
      } else if (tid == 0) {
        halo[i - 1] = hp[c_lo - 1];
      }
    }
    if (w > 0) {
      // (first task of this thread, stride between its tasks)
      const int jj_first = P == 1 ? tid : tid - part * w;
      const int jj_step = P == 1 ? kThreads : w;
      for (int jj = jj_first; jj < w && part < P; jj += jj_step) {
        const int j = c_lo + jj;
        const float sim = s[j];
        float dmax = kNeg, imax = kNeg;
        int dk = INT_MAX, ik = INT_MAX;
        // a deletion's operands (H[i-1, k], D[k, j]), an insertion's
        // (H[k, j-1], Cm[i-k, j])
        auto del = [&](int k, float& h, float& d) {
          h = hp[k];
          d = kResident ? Dsh[(size_t)(k - t0 - 1) * w + jj]
                        : D[(size_t)k * t2 + j];
        };
        auto ins = [&](int k, float& h, float& c) {
          if (kResident) {
            h = Hsh[(size_t)(k - q0 - 1) * w + jj];
            c = Csh[(size_t)(i - k - 2) * w + jj];
          } else {
            h = jj == 0 ? halo[k] : H[(size_t)k * t2 + j - 1];
            c = Cm[(size_t)(i - k) * t2 + j];
          }
        };
        constexpr int kBatch = kResident ? 1 : 8;
        scan_first_max<kBatch>(t0 + 1 + part, j - 2, P, sim, local, del,
                               dmax, dk);
        scan_first_max<kBatch>(q0 + 1 + part, i - 2, P, sim, local, ins,
                               imax, ik);
        if (P > 1) {
          red_v[tid] = dmax;
          red_k[tid] = dk;
          red_v[kThreads + tid] = imax;
          red_k[kThreads + tid] = ik;
          break;  // one task per thread when P > 1
        }
        float best = clampv(hp[j - 1] + sim, local);
        int bq = i - 1, bt = j - 1;
        if (dmax > best) {
          best = dmax;
          bt = dk == INT_MAX ? kNull : dk;
        }
        if (imax > best) {
          best = imax;
          bq = ik == INT_MAX ? kNull : ik;
          bt = j - 1;
        }
        const size_t at = (size_t)i * t2 + j;
        H[at] = best;
        PQ[at] = bq;
        PT[at] = bt;
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(cur, r)[j] = best;
      }
      if (P > 1) {
        __syncthreads();
        // one warp per cell: the parts' pairs, then a butterfly
        for (int jj = warp; jj < w; jj += kWarps) {
          float dv = kNeg, iv = kNeg;
          int dk = INT_MAX, ik = INT_MAX;
          for (int q = lane; q < P; q += 32) {
            take(red_v[q * w + jj], red_k[q * w + jj], dv, dk);
            take(red_v[kThreads + q * w + jj], red_k[kThreads + q * w + jj],
                 iv, ik);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, dv, o);
            const int ok = __shfl_xor_sync(0xffffffffu, dk, o);
            const float oi = __shfl_xor_sync(0xffffffffu, iv, o);
            const int oik = __shfl_xor_sync(0xffffffffu, ik, o);
            take(ov, ok, dv, dk);
            take(oi, oik, iv, ik);
          }
          const int j = c_lo + jj;
          float best = clampv(hp[j - 1] + s[j], local);
          int bq = i - 1, bt = j - 1;
          if (dv > best) {
            best = dv;
            bt = dk == INT_MAX ? kNull : dk;
          }
          if (iv > best) {
            best = iv;
            bq = ik == INT_MAX ? kNull : ik;
            bt = j - 1;
          }
          if (lane == 0) {
            const size_t at = (size_t)i * t2 + j;
            H[at] = best;
            PQ[at] = bq;
            PT[at] = bt;
          }
          if (lane < C) cluster.map_shared_rank(cur, lane)[j] = best;
        }
      }
    }
    cluster.sync();  // row i is in every block's buffer
  }

  // closing cell (q1, t1), by the block that wrote column t1-1 of H: each
  // thread's first maximum over its strided k's, then a block reduction
  // that keeps the lower k on equal values
  const bool closes = (t1 - 1 >= c_lo && t1 - 1 < c_hi) ||
                      (t1 - 1 == t0 + 1 && rank == 0);
  if (!closes) return;
  const float sc = S[(size_t)q1 * t2 + t1];
  const float* hp = rows + (size_t)((q1 - 1) & 1) * t2;
  float dmax = kNeg, imax = kNeg;
  int dk = INT_MAX, ik = INT_MAX;
  for (int k = t0 + 1 + tid; k <= t1 - 1; k += kThreads) {
    const float v = clampv((hp[k] - D[(size_t)k * t2 + t1]) + sc, local);
    if (v > dmax) {
      dmax = v;
      dk = k;
    }
  }
  for (int k = q0 + 1 + tid; k <= q1 - 1; k += kThreads) {
    const float v =
        clampv((H[(size_t)k * t2 + t1 - 1] - insc[k]) + sc, local);
    if (v > imax) {
      imax = v;
      ik = k;
    }
  }
  red_v[tid] = dmax;
  red_k[tid] = dk;
  red_v[kThreads + tid] = imax;
  red_k[kThreads + tid] = ik;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      for (int g = 0; g < 2; ++g) {
        const int a = g * kThreads + tid;
        take(red_v[a + half], red_k[a + half], red_v[a], red_k[a]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    float best = clampv(hp[t1 - 1] + sc, local);
    int bq = q1 - 1;
    int bt = t1 - 1;
    if (red_v[0] > best) {
      best = red_v[0];
      bt = red_k[0];
    }
    if (red_v[kThreads] > best) {
      best = red_v[kThreads];
      bq = red_k[kThreads];
      bt = t1 - 1;
    }
    const size_t c = (size_t)q1 * t2 + t1;
    H[c] = best;
    PQ[c] = bq;
    PT[c] = bt;
  }
}

template <bool kResident>
cudaError_t set_attributes(int cluster, int smem) {
  auto kernel = dp_tb_kernel<kResident>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t config(int n, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kResident>
int launch(const float* S, const float* D, const float* Cm, const float* ins0,
           const float* insc, float* H, int* PQ, int* PT, int n, int q2,
           int t2, int q0, int q1, int t0, int t1, int local, int cluster,
           const Cuts& cuts, int smem, cudaStream_t stream) {
  cudaError_t e = set_attributes<kResident>(cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(n, smem, stream, &attr, cluster);
  e = cudaLaunchKernelEx(&cfg, dp_tb_kernel<kResident>, S, D, Cm, ins0, insc,
                         H, PQ, PT, q2, t2, q0, q1, t0, t1, local, cuts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every tensor pointer is a device
// pointer; stream is a cudaStream_t; cuts points to cluster + 1 host ints
// (dp_engine.k7_plan: cuts[0] = t0 + 2, cuts[cluster] = t1, ascending).
// Returns cudaGetLastError() of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue when the plan does not match the shapes or any
// block needs more than smem bytes of shared memory.
extern "C" int dp_tb_launch(const float* S, const float* D, const float* Cm,
                            const float* ins0, const float* insc, float* H,
                            int* PQ, int* PT, int n, int q2, int t2, int q0,
                            int q1, int t0, int t1, int local, int resident,
                            int cluster, const int* cuts, int smem,
                            void* stream) {
  if (n < 1 || cluster < 2 || cluster > kMaxCluster || cuts[0] != t0 + 2 ||
      cuts[cluster] != t1)
    return (int)cudaErrorInvalidValue;
  Cuts c = {};
  for (int b = 0; b <= cluster; ++b) {
    c.c[b] = cuts[b];
    if (b > 0 && cuts[b] < cuts[b - 1]) return (int)cudaErrorInvalidValue;
    if (b < cluster &&
        sizeof(float) * smem_floats(resident, q2, t2, q0, q1, t0, cuts[b],
                                    cuts[b + 1]) > (size_t)smem)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return resident ? launch<true>(S, D, Cm, ins0, insc, H, PQ, PT, n, q2, t2,
                                 q0, q1, t0, t1, local, cluster, c, smem, st)
                  : launch<false>(S, D, Cm, ins0, insc, H, PQ, PT, n, q2, t2,
                                  q0, q1, t0, t1, local, cluster, c, smem, st);
}

// How many clusters of `cluster` blocks with smem bytes of dynamic shared
// memory the current card can hold at once (cudaOccupancyMaxActiveClusters;
// 0: such a cluster cannot be placed), or minus a CUDA error code.
extern "C" int dp_tb_max_active_clusters(int cluster, int smem, int resident) {
  cudaError_t e = resident ? set_attributes<true>(cluster, smem)
                           : set_attributes<false>(cluster, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(1, smem, 0, &attr, cluster);
  int count = 0;
  e = resident ? cudaOccupancyMaxActiveClusters(&count, dp_tb_kernel<true>,
                                                &cfg)
               : cudaOccupancyMaxActiveClusters(&count, dp_tb_kernel<false>,
                                                &cfg);
  if (e != cudaSuccess) return -(int)e;
  return count;
}

// Shared memory one block can opt into on the current card (232,448 bytes
// on an H100).
extern "C" int dp_tb_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}
