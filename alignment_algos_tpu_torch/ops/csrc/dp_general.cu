// Exact general-gap DP (K3 dp_general_kernel) for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute one function, the reference's
// O(Q*T*(Q+T)) forward recurrence (dpmatrix.h:356-536) on exact costs:
//   alignment_algos_tpu/ops/dp_scores.py _kernel (:62), called by
//     _dp_scores_call (:195): the score H[q1, t1] only;
//   alignment_algos_tpu/ops/dp_pallas.py _kernel / _row_body (:67, :77),
//     called by _dp_pallas_batched (:193): the full H.
// One launch scores a ragged batch of pairs, each described by a Pair
// (its S, its H buffer, its costs, q2, t2 and output slot).  The kernel
// writes the full H of each pair into its buffer (scratch when only the
// score is wanted) and the closing cell into out[slot].  The bounds are
// the whole matrix: q0 = t0 = 0, q1 = q2 - 1, t1 = t2 - 1.
//
// Where the costs come from (the template's kVec):
//   table form: D (t2, t2), Cm (q2, t2), ins0 (q2), insc (q2), dclose (t2)
//     as ops/dp_scores.prepare_tables builds them;
//   vector form (the HMAP costs): the gap vectors gi, ge and the insertion
//     coefficients A, B (and C) of length t2, staged in shared memory; the
//     kernel rebuilds each cost with prepare_tables' roundings:
//       D[k, j]  = min(gi[k], gi[j]) + min(ge[k], ge[j]) * ((j - k) - 2),
//                  0 for j - k < 2; with del_free, row 0 and column t1 are 0;
//       Cm[m, j] = A[j] + B[j] * (m - off) (+ C[j]), 0 for m < 2;
//       ins0[i]  = Cm[i, 1] unless zero_head; insc[m] = Cm[m, t1] unless
//                  zero_tail.
//     Each min propagates NaN (torch.minimum); its sign of zero cannot
//     reach a result (see below).  Nothing is contracted: -fmad=false.
//
// Recurrence, per pair (float32; clamp(x) = max(x, +0) when local):
//   row 0 and every cell the rows below do not set: 0;
//   row 1:       H[1, 1] = clamp(S[1, 1]);
//                H[1, j] = clamp((0 - D[0, j]) + S[1, j]),  2 <= j <= t1-1;
//   rows i in [2, q1-1]:
//                H[i, 1] = clamp((0 - ins0[i]) + S[i, 1]);
//                H[i, j] = maxp(clamp(H[i-1, j-1] + s),
//                               maxp(clamp(del + s), clamp(ins + s))),
//                del = +0 + max(NEG, max_k (H[i-1, k] - D[k, j])), k in [1, j-2],
//                ins = +0 + max(NEG, max_m (H[i-m, j-1] - Cm[m, j])), m in [2, i-1],
//                s = S[i, j], 2 <= j <= t1-1;
//   row q1:      H[q1, t1] the same with k in [1, t1-1] against dclose[k] and
//                m in [1, q1-1] against insc[m]; the rest of the row is 0.
// The similarity is added after the max, as dp_scores does: fl(x + s) is
// monotone in x, so the result equals the per-candidate form of dp_pallas
// and dp_ref.  Both gap maxima propagate NaN (max.NaN) and are taken in any
// order: max is order-free except for the sign of a zero maximum, and the
// "+0 +" (the JAX kernel adds its 0 / NEG mask to every candidate) makes
// that +0.  So a zero candidate's sign, and with it the sign of a zero
// cost, never reaches a cell; the remaining maxima are ordered (maxp:
// the left operand on a tie; del and ins are never -0) and clamp turns
// -0 into +0, as jnp.maximum does.  tests/test_torch_dp_scores.py holds
// the plain version against the JAX package on -0.0 and NaN inputs.
//
// Design.  One block per pair; its threads stride over the columns j.
// - One launch for all pairs, the longest first (the wrapper sorts the
//   descriptors), so a 1024-template library fills all 132 SMs at once.
// - In the vector form no cost table exists: gi, ge (interleaved as pairs),
//   A, B and C sit in shared memory and each candidate's cost is rebuilt
//   in registers, so the kernel reads S and five vectors per pair instead
//   of a (t2, t2) and a (q2, t2) table.
// - Rows in shared memory: the last R + 1 rows sit in a ring there, so the
//   deletion scan reads H[i-1, k] as a shared-memory broadcast, four k at
//   a time (128-bit loads of H and of two (gi, ge) pairs; the row stride
//   is rounded up to 4 floats).
// - The insertion history H[i-m, j-1] stays in the pair's H buffer in
//   global memory, row-major: a warp reads 32 neighbouring columns of one
//   row, one 128-byte line per read (a column-major history would make
//   each thread's reads contiguous but scatter the warp's).  It is folded
//   R rows at a time: one pass over the rows up to i0 - 2 feeds R register
//   accumulators (rows i0 .. i0+R-1), kept in shared memory (iacc) until
//   their row is computed; the few candidates from rows i0-1 .. i-2 come
//   from the ring.  So each history row is read once per R rows.
// - R (8, 4, 2 or 1) and the dynamic shared memory follow the longest t2
//   of the launch: (2R + 1) rows, plus 5 for the vectors, plus a reduction
//   buffer; above 48 KB through cudaFuncSetAttribute.  No size gate and no
//   fallback: the vector form runs t2 up to 2,616 at R = 8 and 7,200 at
//   R = 1, the table form up to 19,200; a longer pair fails at launch.
//   dp_general_max_t2 reports the cap, and the profile screen sends a
//   longer template's bucket to K7 (ops/hmap_device.screen_hmap_device).
// - The closing cell is a block-wide max over shared memory.
//
// What bounds it.  Every candidate is a subtract and a max, plus its cost
// in the vector form: two mins, a multiply and an add for a deletion, a
// multiply and an add for an insertion.  Per pair that is O(q2 t2 (q2 +
// t2)) operations against O(q2 t2) bytes of S: the kernel is bound by
// operations (a subtract and a max per candidate: 1.07 ms for the
// 1024-template profile screen on an H100), and by the row-to-row
// dependence (a __syncthreads() per row), which the five resident blocks
// per SM (48 registers a thread) hide in part.  Measured on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit: the whole screen in one launch
// 10.4-11.2 ms (1.99-2.03 s in 253 launches before); one pair's chain, a
// 5 x 258 x 258 bucket alone, 2.6 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // dp_scores.NEG
constexpr int kThreads = 256;

// One pair of a launch (72 bytes; ops/dp_scores.PAIR_DTYPE mirrors it).
// Vector form: c0 = gi, c1 = ge, c2 = A, c3 = B, c4 = C (or null).
// Table form: c0 = D, c1 = Cm, c2 = ins0, c3 = insc, c4 = dclose.
struct Pair {
  const float* S;
  float* H;
  const float* c0;
  const float* c1;
  const float* c2;
  const float* c3;
  const float* c4;
  int32_t q2, t2, slot, pad;
};

struct Flags {
  int local, zero_head, zero_tail, del_free;
  float off;
};

// NaN-propagating max and min (PTX .NaN forms; one instruction each).
__device__ __forceinline__ float maxn(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float minn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Ordered NaN-propagating max: a if a > b or a is NaN, else b.
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float clampv(float x, int local) {
  return local ? maxp(x, 0.0f) : x;
}

// A gap maximum's term of a cell: +0 + acc (a zero maximum becomes +0),
// then the similarity, then the clamp.
__device__ __forceinline__ float gap_term(float acc, float s, int local) {
  return clampv(__fadd_rn(__fadd_rn(acc, 0.0f), s), local);
}

// Deletion cost D[k, j] of the vector form, j - k >= 2: min(gi), then
// min(ge) times the float distance d = (j - k) - 2, then the add.
__device__ __forceinline__ float del_vec(float gik, float gek, float gij,
                                         float gej, float d) {
  return __fadd_rn(minn(gik, gij), __fmul_rn(minn(gek, gej), d));
}

// The deletion maximum of column j >= 2 in the vector form: max over k in
// [1, j-2] of H[i-1, k] - D[k, j], D rebuilt from the (gi, ge) pairs.  k
// runs in groups of 4 from a multiple of 4 (prev and vgg are 16-byte
// aligned there: one 128-bit shared-memory broadcast each for H and for two
// pairs), into two accumulators; max is order-free in value (a zero's sign
// is fixed later by gap_term, a NaN propagates either way).
__device__ __forceinline__ float del_scan(const float* prev, const float* vgg,
                                          int j) {
  const float gij = vgg[2 * j], gej = vgg[2 * j + 1];
  const int kend = j - 2;
  float acc0 = kNeg, acc1 = kNeg;
  float d = (float)(j - 1) - 2.0f;       // (j - k) - 2 at k = 1, exact
  int k = 1;
  for (; k <= kend && (k & 3); ++k) {
    acc0 = maxn(acc0, __fsub_rn(prev[k], del_vec(vgg[2 * k], vgg[2 * k + 1],
                                                 gij, gej, d)));
    d = __fsub_rn(d, 1.0f);
  }
  for (; k + 3 <= kend; k += 4) {
    const float4 h = *reinterpret_cast<const float4*>(prev + k);
    const float4 g01 = *reinterpret_cast<const float4*>(vgg + 2 * k);
    const float4 g23 = *reinterpret_cast<const float4*>(vgg + 2 * k + 4);
    acc0 = maxn(acc0, __fsub_rn(h.x, del_vec(g01.x, g01.y, gij, gej, d)));
    acc1 = maxn(acc1, __fsub_rn(h.y, del_vec(g01.z, g01.w, gij, gej,
                                             __fsub_rn(d, 1.0f))));
    acc0 = maxn(acc0, __fsub_rn(h.z, del_vec(g23.x, g23.y, gij, gej,
                                             __fsub_rn(d, 2.0f))));
    acc1 = maxn(acc1, __fsub_rn(h.w, del_vec(g23.z, g23.w, gij, gej,
                                             __fsub_rn(d, 3.0f))));
    d = __fsub_rn(d, 4.0f);
  }
  for (; k <= kend; ++k) {
    acc0 = maxn(acc0, __fsub_rn(prev[k], del_vec(vgg[2 * k], vgg[2 * k + 1],
                                                 gij, gej, d)));
    d = __fsub_rn(d, 1.0f);
  }
  return maxn(acc0, acc1);
}

// Insertion cost of the vector form at distance m >= 2, mo = m - off.
__device__ __forceinline__ float ins_vec(float a, float b, const float* c,
                                         int j, float mo) {
  const float v = __fadd_rn(a, __fmul_rn(b, mo));
  return c ? __fadd_rn(v, c[j]) : v;
}

template <bool kVec, int R>
__global__ void __launch_bounds__(kThreads)
    dp_general_kernel(const Pair* __restrict__ pairs, float* __restrict__ out,
                      int ld, Flags f) {
  extern __shared__ float sm[];
  const Pair pr = pairs[blockIdx.x];
  const int q2 = pr.q2, t2 = pr.t2;
  const int q1 = q2 - 1, t1 = t2 - 1;
  const int tid = threadIdx.x;
  const float* __restrict__ S = pr.S;
  float* __restrict__ H = pr.H;
  float* rows = sm;                      // ring: row r in slot r % (R + 1)
  float* iacc = rows + (R + 1) * ld;     // R x ld folded insertion maxima
  float* red = iacc + R * ld;            // 2 x kThreads
  float* vgg = red + 2 * kThreads;       // vector form: (gi, ge) pairs,
  float* vA = vgg + 2 * ld;              // then A, B and C
  float* vB = vA + ld;
  float* vC = vB + ld;
  const float* cvec = nullptr;           // vC, or null without a C term
  if (kVec) {
    for (int j = tid; j < t2; j += kThreads) {
      vgg[2 * j] = pr.c0[j];
      vgg[2 * j + 1] = pr.c1[j];
      vA[j] = pr.c2[j];
      vB[j] = pr.c3[j];
      if (pr.c4) vC[j] = pr.c4[j];
    }
    if (pr.c4) cvec = vC;
  }

  // row 0 and row 1
  for (int j = tid; j < t2; j += kThreads) {
    H[j] = 0.0f;
    float v = 0.0f;
    if (j == 1) {
      v = clampv(S[t2 + 1], f.local);
    } else if (j >= 2 && j <= t1 - 1) {
      float d0;
      if (kVec) {
        d0 = f.del_free ? 0.0f
                        : del_vec(pr.c0[0], pr.c1[0], pr.c0[j], pr.c1[j],
                                  (float)j - 2.0f);
      } else {
        d0 = pr.c0[j];
      }
      v = clampv(__fadd_rn(__fsub_rn(0.0f, d0), S[t2 + j]), f.local);
    }
    rows[(1 % (R + 1)) * ld + j] = v;
    H[t2 + j] = v;
  }
  __syncthreads();

  for (int i0 = 2; i0 <= q1 - 1; i0 += R) {
    const int nr = min(R, q1 - i0);      // rows i0 .. i0+nr-1 in this tile
    // fold the history rows 1 .. i0-2 into the tile's R accumulators
    for (int j = tid; j < t2; j += kThreads) {
      if (j < 2 || j > t1 - 1) continue;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = kNeg;
      float aj = 0.0f, bj = 0.0f;
      if (kVec) {
        aj = vA[j];
        bj = vB[j];
      }
      // vector form: four history loads in flight; the table form reads
      // R costs per row from global memory and keeps its loop rolled
      constexpr int kFoldUnroll = kVec ? 4 : 1;
#pragma unroll kFoldUnroll
      for (int r0 = 1; r0 <= i0 - 2; ++r0) {
        const float h = H[(size_t)r0 * t2 + j - 1];
        const float mo = (float)(i0 - r0) - f.off;   // exact integers
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) {
            float c;
            if (kVec) {
              c = ins_vec(aj, bj, cvec, j, __fadd_rn(mo, (float)r));
            } else {
              c = pr.c1[(size_t)(i0 + r - r0) * t2 + j];
            }
            acc[r] = maxn(acc[r], __fsub_rn(h, c));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) iacc[r * ld + j] = acc[r];
    }

    for (int r = 0; r < nr; ++r) {
      const int i = i0 + r;
      const float* prev = rows + ((i - 1) % (R + 1)) * ld;
      float* cur = rows + (i % (R + 1)) * ld;
      const float* s = S + (size_t)i * t2;
      for (int j = tid; j < t2; j += kThreads) {
        float v = 0.0f;
        if (j == 1) {
          float c0 = 0.0f;
          if (kVec) {
            if (!f.zero_head && i >= 2)
              c0 = ins_vec(vA[1], vB[1], cvec, 1, (float)i - f.off);
          } else {
            c0 = pr.c2[i];
          }
          v = clampv(__fadd_rn(__fsub_rn(0.0f, c0), s[1]), f.local);
        } else if (j >= 2 && j <= t1 - 1) {
          const float sim = s[j];
          const float match = clampv(__fadd_rn(prev[j - 1], sim), f.local);
          float dacc = kNeg;
          if (kVec) {
            dacc = del_scan(prev, vgg, j);
          } else {
            const float* Dj = pr.c0 + j;
#pragma unroll 4
            for (int k = 1; k <= j - 2; ++k)
              dacc = maxn(dacc, __fsub_rn(prev[k], Dj[(size_t)k * t2]));
          }
          // the tile's own rows i0-1 .. i-2 (distances m = i - r0 >= 2)
          float iacc_j = iacc[r * ld + j];
          for (int r0 = i0 - 1; r0 <= i - 2; ++r0) {
            const float h = rows[(r0 % (R + 1)) * ld + j - 1];
            float c;
            if (kVec) {
              c = ins_vec(vA[j], vB[j], cvec, j, (float)(i - r0) - f.off);
            } else {
              c = pr.c1[(size_t)(i - r0) * t2 + j];
            }
            iacc_j = maxn(iacc_j, __fsub_rn(h, c));
          }
          v = maxp(match, maxp(gap_term(dacc, sim, f.local),
                               gap_term(iacc_j, sim, f.local)));
        }
        cur[j] = v;
        H[(size_t)i * t2 + j] = v;
      }
      __syncthreads();
    }
  }

  // closing row q1: one cell, a block-wide max over both gap kinds
  const float* hp = rows + ((q1 - 1) % (R + 1)) * ld;
  float dacc = kNeg;
  for (int k = 1 + tid; k <= t1 - 1; k += kThreads) {
    float c;
    if (kVec) {
      c = (f.del_free || t1 - k < 2)
              ? 0.0f
              : del_vec(vgg[2 * k], vgg[2 * k + 1], vgg[2 * t1],
                        vgg[2 * t1 + 1], (float)(t1 - k) - 2.0f);
    } else {
      c = pr.c4[k];
    }
    dacc = maxn(dacc, __fsub_rn(hp[k], c));
  }
  float iacc_c = kNeg;
  for (int m = 1 + tid; m <= q1 - 1; m += kThreads) {
    float c;
    if (kVec) {
      c = (f.zero_tail || m < 2)
              ? 0.0f
              : ins_vec(vA[t1], vB[t1], cvec, t1, (float)m - f.off);
    } else {
      c = pr.c3[m];
    }
    iacc_c = maxn(iacc_c, __fsub_rn(H[(size_t)(q1 - m) * t2 + t1 - 1], c));
  }
  red[tid] = dacc;
  red[kThreads + tid] = iacc_c;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[tid] = maxn(red[tid], red[tid + w]);
      red[kThreads + tid] = maxn(red[kThreads + tid], red[kThreads + tid + w]);
    }
    __syncthreads();
  }
  float* hq = H + (size_t)q1 * t2;
  for (int j = tid; j < t2; j += kThreads) {
    if (j != t1) hq[j] = 0.0f;
  }
  if (tid == 0) {
    const float sc = S[(size_t)q1 * t2 + t1];
    const float best =
        maxp(clampv(__fadd_rn(hp[t1 - 1], sc), f.local),
             maxp(gap_term(red[0], sc, f.local),
                  gap_term(red[kThreads], sc, f.local)));
    hq[t1] = best;
    out[pr.slot] = best;
  }
}

// Shared-memory floats per row: the largest t2 rounded up to 4, so that each
// row and the (gi, ge) pairs start 16-byte aligned.
int row_stride(int t2) { return (t2 + 3) & ~3; }

size_t smem_bytes(int ld, int vec, int R) {
  return sizeof(float) *
         ((size_t)(2 * R + 1) * ld + 2 * kThreads + (vec ? 5 * (size_t)ld : 0));
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <bool kVec, int R>
int launch(const void* pairs, float* out, int n, int ld, Flags f,
           cudaStream_t stream) {
  auto kernel = dp_general_kernel<kVec, R>;
  const size_t smem = smem_bytes(ld, kVec, R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n, kThreads, smem, stream>>>(static_cast<const Pair*>(pairs), out,
                                        ld, f);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_rows(int R, const void* pairs, float* out, int n, int ld, Flags f,
                cudaStream_t stream) {
  switch (R) {
    case 8: return launch<kVec, 8>(pairs, out, n, ld, f, stream);
    case 4: return launch<kVec, 4>(pairs, out, n, ld, f, stream);
    case 2: return launch<kVec, 2>(pairs, out, n, ld, f, stream);
    default: return launch<kVec, 1>(pairs, out, n, ld, f, stream);
  }
}

// Rows per tile (8, 4, 2 or 1) for a row stride ld, in the vector form
// (vec = 1) or the table form: the largest whose shared memory fits the
// card; 0 when none does.
int tile_rows(int ld, int vec) {
  const size_t cap = (size_t)max_smem_optin();
  for (int R = 8; R >= 1; R /= 2)
    if (smem_bytes(ld, vec, R) <= cap) return R;
  return 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  pairs: n Pair descriptors in
// device memory; out: device float32 scores indexed by Pair.slot; ld: the
// largest t2 among the pairs; stream: a cudaStream_t.  Returns
// cudaGetLastError() of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue when no tile fits in shared memory.
extern "C" int dp_general_launch(const void* pairs, float* out, int n, int ld,
                                 int vec, int local, int zero_head,
                                 int zero_tail, int del_free, float off,
                                 void* stream) {
  ld = row_stride(ld);
  const int R = tile_rows(ld, vec);
  if (R == 0 || n < 1) return (int)cudaErrorInvalidValue;
  const Flags f{local, zero_head, zero_tail, del_free, off};
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_rows<true>(R, pairs, out, n, ld, f, s)
             : launch_rows<false>(R, pairs, out, n, ld, f, s);
}

// The largest t2 a launch takes in the vector form (vec = 1) or the table
// form on the current card: the longest pair for which tile_rows finds a
// tile (7,200 and 19,200 with 227 KB of shared memory per block).
extern "C" int dp_general_max_t2(int vec) {
  int lo = 0, hi = 1 << 20;  // tile_rows falls as t2 grows
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_rows(row_stride(mid), vec) > 0) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}
