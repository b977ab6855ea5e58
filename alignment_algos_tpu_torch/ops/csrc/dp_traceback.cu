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
// Design.  One block per pair, its threads striding over the columns j;
// the rows run in order with one __syncthreads() between them, and H, PQ
// and PT live in device memory (no shared-memory row, so no size limit).
// The previous row is read by every thread at the same k (a broadcast that
// stays in L1); D[k, j], Cm[m, j] and H[k, j-1] are read by neighbouring
// threads at neighbouring j (coalesced).  The closing cell is a block-wide
// reduction of (value, k) pairs in which equal values resolve to the lower
// k, so no thread's timing decides a tie.
//
// What bounds it.  Each candidate costs two loads, a subtract, an add, a
// clamp and a compare-select; per row the deletion scan reads the upper
// triangle of D and the insertion scan i rows of Cm and H, through L1/L2.
// One DPMatrix is one pair, so a launch keeps one block on one of the 132
// SMs: the kernel is bound by the latency of one SM's loads.  A wavefront
// over several blocks per pair, and the rows in shared memory, are later
// work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // dp_engine.NEG
constexpr int kThreads = 512;
constexpr int kNull = -1;

// max(0, x) when local; -0.0 gives +0.0, as torch.maximum(0, x) does
__device__ __forceinline__ float clampv(float x, int local) {
  return (local && !(x > 0.0f)) ? 0.0f : x;
}

// S, Cm, H, PQ, PT: (n, q2, t2); D: (n, t2, t2); ins0, insc: (n, q2).
// 0 <= q0, q0 + 2 <= q1 < q2 and the same for t (the wrapper checks).
__global__ void dp_tb_kernel(const float* __restrict__ S,
                             const float* __restrict__ D,
                             const float* __restrict__ Cm,
                             const float* __restrict__ ins0,
                             const float* __restrict__ insc, float* H,
                             int* PQ, int* PT, int q2, int t2, int q0, int q1,
                             int t0, int t1, int local) {
  __shared__ float red_v[2][kThreads];
  __shared__ int red_k[2][kThreads];
  const size_t p = blockIdx.x;
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
  const int nt = blockDim.x;

  for (size_t c = tid; c < qt; c += nt) {
    H[c] = 0.0f;
    PQ[c] = kNull;
    PT[c] = kNull;
  }
  __syncthreads();

  // boundary row q0+1 and column t0+1, from the origin (q0, t0)
  {
    const float* s = S + (size_t)(q0 + 1) * t2;
    const size_t row = (size_t)(q0 + 1) * t2;
    for (int j = t0 + 1 + tid; j <= t1 - 1; j += nt) {
      H[row + j] = j == t0 + 1
                       ? clampv(0.0f + s[j], local)
                       : clampv((0.0f - D[(size_t)t0 * t2 + j]) + s[j], local);
      PQ[row + j] = q0;
      PT[row + j] = t0;
    }
    for (int i = q0 + 2 + tid; i <= q1 - 1; i += nt) {
      const size_t c = (size_t)i * t2 + t0 + 1;
      H[c] = clampv((0.0f - ins0[i]) + S[c], local);
      PQ[c] = q0;
      PT[c] = t0;
    }
  }
  __syncthreads();

  for (int i = q0 + 2; i <= q1 - 1; ++i) {
    const float* s = S + (size_t)i * t2;
    const float* hp = H + (size_t)(i - 1) * t2;
    const size_t row = (size_t)i * t2;
    for (int j = t0 + 2 + tid; j <= t1 - 1; j += nt) {
      const float sim = s[j];
      float best = clampv(hp[j - 1] + sim, local);
      int bq = i - 1;
      int bt = j - 1;
      float dmax = kNeg;
      int dk = kNull;
#pragma unroll 4
      for (int k = t0 + 1; k <= j - 2; ++k) {
        const float v = clampv((hp[k] - D[(size_t)k * t2 + j]) + sim, local);
        if (v > dmax) {
          dmax = v;
          dk = k;
        }
      }
      float imax = kNeg;
      int ik = kNull;
#pragma unroll 4
      for (int k = q0 + 1; k <= i - 2; ++k) {
        const float v = clampv(
            (H[(size_t)k * t2 + j - 1] - Cm[(size_t)(i - k) * t2 + j]) + sim,
            local);
        if (v > imax) {
          imax = v;
          ik = k;
        }
      }
      if (dmax > best) {
        best = dmax;
        bt = dk;
      }
      if (imax > best) {
        best = imax;
        bq = ik;
        bt = j - 1;
      }
      H[row + j] = best;
      PQ[row + j] = bq;
      PT[row + j] = bt;
    }
    __syncthreads();
  }

  // closing cell (q1, t1): each thread's first maximum over its strided
  // k's, then a block reduction that keeps the lower k on equal values
  const float sc = S[(size_t)q1 * t2 + t1];
  const float* hp = H + (size_t)(q1 - 1) * t2;
  float dmax = kNeg, imax = kNeg;
  int dk = INT_MAX, ik = INT_MAX;
  for (int k = t0 + 1 + tid; k <= t1 - 1; k += nt) {
    const float v = clampv((hp[k] - D[(size_t)k * t2 + t1]) + sc, local);
    if (v > dmax) {
      dmax = v;
      dk = k;
    }
  }
  for (int k = q0 + 1 + tid; k <= q1 - 1; k += nt) {
    const float v =
        clampv((H[(size_t)k * t2 + t1 - 1] - insc[k]) + sc, local);
    if (v > imax) {
      imax = v;
      ik = k;
    }
  }
  red_v[0][tid] = dmax;
  red_k[0][tid] = dk;
  red_v[1][tid] = imax;
  red_k[1][tid] = ik;
  __syncthreads();
  for (int w = nt / 2; w > 0; w >>= 1) {
    if (tid < w) {
      for (int g = 0; g < 2; ++g) {
        const float v = red_v[g][tid + w];
        const int k = red_k[g][tid + w];
        if (v > red_v[g][tid] || (v == red_v[g][tid] && k < red_k[g][tid])) {
          red_v[g][tid] = v;
          red_k[g][tid] = k;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    float best = clampv(hp[t1 - 1] + sc, local);
    int bq = q1 - 1;
    int bt = t1 - 1;
    if (red_v[0][0] > best) {
      best = red_v[0][0];
      bt = red_k[0][0];
    }
    if (red_v[1][0] > best) {
      best = red_v[1][0];
      bq = red_k[1][0];
      bt = t1 - 1;
    }
    const size_t c = (size_t)q1 * t2 + t1;
    H[c] = best;
    PQ[c] = bq;
    PT[c] = bt;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  Returns cudaGetLastError() of the
// launch (0 = cudaSuccess).
extern "C" int dp_tb_launch(const float* S, const float* D, const float* Cm,
                            const float* ins0, const float* insc, float* H,
                            int* PQ, int* PT, int n, int q2, int t2, int q0,
                            int q1, int t0, int t1, int local, void* stream) {
  dp_tb_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      S, D, Cm, ins0, insc, H, PQ, PT, q2, t2, q0, q1, t0, t1, local);
  return (int)cudaGetLastError();
}
