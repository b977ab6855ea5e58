// Exact general-gap DP (K3 dp_general_kernel) for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute one function, the reference's
// O(Q*T*(Q+T)) forward recurrence (dpmatrix.h:356-536) on host-exact cost
// tables:
//   alignment_algos_tpu/ops/dp_scores.py _kernel (:62), called by
//     _dp_scores_call (:195): the score H[q1, t1] only;
//   alignment_algos_tpu/ops/dp_pallas.py _kernel / _row_body (:67, :77),
//     called by _dp_pallas_batched (:193): the full H.
// This kernel always writes the full H into the buffer it is given and the
// closing cell into out[p]; the wrapper returns one or the other (in the
// scores mode the buffer is scratch).  The bounds are the whole matrix:
// q0 = t0 = 0, q1 = q2 - 1, t1 = t2 - 1, as every caller uses them.
//
// Recurrence, per pair p (all float32; clamp(x) = max(0, x) when local):
//   row 0 and every cell the rows below do not set: 0;
//   row 1:       H[1, 1] = clamp(S[1, 1]);
//                H[1, j] = clamp((0 - D[0, j]) + S[1, j]),  2 <= j <= t1-1;
//   rows i in [2, q1-1]:
//                H[i, 1] = clamp((0 - ins0[i]) + S[i, 1]);
//                H[i, j] = max(clamp(H[i-1, j-1] + s),
//                              max(clamp(max(NEG, max_k (H[i-1, k] - D[k, j])) + s),
//                                  clamp(max(NEG, max_m (H[i-m, j-1] - Cm[m, j])) + s)))
//                with k in [1, j-2], m in [2, i-1], s = S[i, j], 2 <= j <= t1-1;
//   row q1:      H[q1, t1] the same with k in [1, t1-1] against dclose[k] and
//                m in [1, q1-1] against insc[m]; the rest of the row is 0.
// The similarity is added after the masked max, as dp_scores does: fl(x + s)
// is monotone in x, so fl(max_k x_k + s) == max_k fl(x_k + s) and the
// result equals the per-candidate form fl(fl(H - c) + s) of dp_pallas and
// dp_ref exactly; the clamp comes last, and max commutes with it too.
// Every max propagates NaN (torch.maximum and jnp.maximum semantics), so a
// degenerate NaN similarity gives the plain version's answer.  Nothing is
// multiplied here; the build passes -fmad=false all the same.
//
// Design.  One block per pair; its threads stride over the columns j, and
// the rows run in order with one __syncthreads() between them.  The H rows
// live in the (q2, t2) buffer in global memory: the previous row is read by
// every thread at the same k (a broadcast that stays in L1), D[k, j],
// Cm[m, j] and H[i-m, j-1] are read by neighbouring threads at neighbouring
// j (coalesced).  No shared-memory row, so there is no size limit: a pair
// of any length runs here, where the TPU needed a VMEM cap and a fallback.
// The closing cell is a block-wide max over shared memory.
//
// What bounds it.  Each candidate costs two loads, a subtract and a max;
// per row the deletion scan reads the upper triangle of D (t2^2/2 floats)
// and the insertion scan i rows of Cm and H, so a 258 x 386 pair streams
// about 0.2 GB through L1/L2.  One block per pair leaves most of the 132
// SMs idle when a length bucket holds a few pairs: the kernel is bound by
// L2 latency and occupancy.  Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit: 7.8 ms for a 5-pair 258 x 258 bucket, 8.9 ms for 64
// pairs of 258 x 258 (the pairs run side by side), about 4.4e9 candidate
// evaluations per second per pair.  Later work: a wavefront over several
// blocks per pair, D rebuilt in registers from the two gap vectors, rows in
// shared memory, one launch over all buckets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // dp_scores.NEG
constexpr int kThreads = 256;

// NaN-propagating max: returns a if a > b or a is NaN, else b.
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float clampv(float x, int local) {
  return local ? maxp(0.0f, x) : x;
}

// S, Cm, H: (n, q2, t2); D: (n, t2, t2); ins0, insc: (n, q2);
// dclose: (n, t2); out: (n,).  q2 >= 3 and t2 >= 3 (the wrapper checks).
__global__ void dp_general_kernel(const float* __restrict__ S,
                                  const float* __restrict__ D,
                                  const float* __restrict__ Cm,
                                  const float* __restrict__ ins0,
                                  const float* __restrict__ insc,
                                  const float* __restrict__ dclose,
                                  float* H, float* __restrict__ out, int q2,
                                  int t2, int local) {
  __shared__ float red_d[kThreads];
  __shared__ float red_i[kThreads];
  const size_t p = blockIdx.x;
  const size_t qt = (size_t)q2 * t2;
  S += p * qt;
  Cm += p * qt;
  H += p * qt;
  D += p * (size_t)t2 * t2;
  ins0 += p * q2;
  insc += p * q2;
  dclose += p * t2;
  const int q1 = q2 - 1;
  const int t1 = t2 - 1;
  const int tid = threadIdx.x;

  for (int j = tid; j < t2; j += blockDim.x) H[j] = 0.0f;
  for (int j = tid; j < t2; j += blockDim.x) {
    float v = 0.0f;
    if (j == 1) {
      v = clampv(S[t2 + 1], local);
    } else if (j >= 2 && j <= t1 - 1) {
      v = clampv((0.0f - D[j]) + S[t2 + j], local);
    }
    H[t2 + j] = v;
  }
  __syncthreads();

  for (int i = 2; i <= q1 - 1; ++i) {
    const float* s = S + (size_t)i * t2;
    const float* hp = H + (size_t)(i - 1) * t2;
    float* h = H + (size_t)i * t2;
    for (int j = tid; j < t2; j += blockDim.x) {
      float v = 0.0f;
      if (j == 1) {
        v = clampv((0.0f - ins0[i]) + s[1], local);
      } else if (j >= 2 && j <= t1 - 1) {
        const float sim = s[j];
        const float match = clampv(hp[j - 1] + sim, local);
        float dacc = kNeg;
#pragma unroll 4
        for (int k = 1; k <= j - 2; ++k)
          dacc = maxp(dacc, hp[k] - D[(size_t)k * t2 + j]);
        float iacc = kNeg;
#pragma unroll 4
        for (int m = 2; m <= i - 1; ++m)
          iacc = maxp(iacc, H[(size_t)(i - m) * t2 + j - 1] -
                                Cm[(size_t)m * t2 + j]);
        v = maxp(match, maxp(clampv(dacc + sim, local),
                             clampv(iacc + sim, local)));
      }
      h[j] = v;
    }
    __syncthreads();
  }

  // closing row q1: one cell, a block-wide max over both gap kinds
  const float* hp = H + (size_t)(q1 - 1) * t2;
  float dacc = kNeg;
  for (int k = 1 + tid; k <= t1 - 1; k += blockDim.x)
    dacc = maxp(dacc, hp[k] - dclose[k]);
  float iacc = kNeg;
  for (int m = 1 + tid; m <= q1 - 1; m += blockDim.x)
    iacc = maxp(iacc, H[(size_t)(q1 - m) * t2 + t1 - 1] - insc[m]);
  red_d[tid] = dacc;
  red_i[tid] = iacc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_d[tid] = maxp(red_d[tid], red_d[tid + w]);
      red_i[tid] = maxp(red_i[tid], red_i[tid + w]);
    }
    __syncthreads();
  }
  float* hq = H + (size_t)q1 * t2;
  for (int j = tid; j < t2; j += blockDim.x) {
    if (j != t1) hq[j] = 0.0f;
  }
  if (tid == 0) {
    const float sc = S[(size_t)q1 * t2 + t1];
    const float best =
        maxp(clampv(hp[t1 - 1] + sc, local),
             maxp(clampv(red_d[0] + sc, local), clampv(red_i[0] + sc, local)));
    hq[t1] = best;
    out[p] = best;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  Returns cudaGetLastError() of the
// launch (0 = cudaSuccess).
extern "C" int dp_general_launch(const float* S, const float* D,
                                 const float* Cm, const float* ins0,
                                 const float* insc, const float* dclose,
                                 float* H, float* out, int n, int q2, int t2,
                                 int local, void* stream) {
  dp_general_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      S, D, Cm, ins0, insc, dclose, H, out, q2, t2, local);
  return (int)cudaGetLastError();
}
