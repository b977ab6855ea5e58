// Batched local affine-gap Smith-Waterman (Gotoh) for Hopper (sm_90a).
//
// Two kernels, one recurrence:
//   K1 sw_scores_kernel  -> (B,) best local score per lane.
//      Replaces the TPU kernels alignment_algos_tpu/ops/swscan.py
//      _rowscan_kernel (:66), ops/swstrip.py _sw_strip_kernel (:49) and
//      ops/swaffine.py _sw_kernel (:56).  All three compute this function.
//   K2 sw_tb_kernel      -> per-cell traceback codes, per-row running max
//      and the anti-diagonal of that max.  Replaces ops/swaffine.py
//      _sw_tb_kernel (:178).
//
// Design.  One thread owns one lane b (a query/template pair) and walks
// the matrix row by row: i over the query, j over the template inside.
// E and H(i, j-1) live in registers; the previous H row and the F row live
// in global scratch of shape (T, B), indexed [j*B + b], so a warp's loads
// and stores coalesce across lanes.  The similarity is looked up in the
// kernel from the substitution table in shared memory, so no (Q, T, B)
// similarity tensor is ever built.  Lanes are independent: no state
// crosses blocks, which replaces the TPU kernels' VMEM scratch carried
// across sequential grid steps.
//
// Exactness.  Every value is built with float32 add, subtract and max in
// the op order of the JAX twins (swaffine.py sw_affine_scores_xla :544 and
// sw_affine_tb_xla :584), so results are bit-equal to them for any gap
// values, fractional ones included:
//   * H outside the matrix is 0: the diagonal term at i==0 or j==0 is 0+s;
//   * E enters column 0 from NEG with H(i,-1)=0: E(i,0)=max(NEG-ge, 0-gi);
//   * both F candidates are NEG in row 0;
//   * H = max(max(diag, 0), max(E, F));
//   * K2's code: 0 if H==0, else 1 if H==diag, else 2 if H==E, else 3; then
//     |4 if e_ext > e_open and |8 if f_ext > f_open (strict);
//   * the running max per row updates on a strict >, and j increases with
//     the anti-diagonal d = i + j, so the first maximum wins as on the TPU.
// Nothing is multiplied; the build still passes -fmad=false.
//
// What bounds it.  Each cell costs one dependent chain of a few float ops
// plus three 4-byte loads and two 4-byte stores on the (T, B) scratch.  With
// one lane per thread a 5120-lane screen is 40 blocks of 128 threads, so
// 40 of the 132 SMs hold four warps each: the kernel is bound by the
// latency of the scratch traffic at low occupancy, not by bandwidth or
// arithmetic.  Later work: several threads per lane (anti-diagonal tiles in
// shared memory), H/F rows kept in shared memory or registers, and DPX
// integer max/add (__viaddmax_s32) when table and gaps are integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // swaffine.NEG; NEG - ge rounds back to NEG
constexpr int kThreads = 128;

// One Gotoh cell.  hdiag = H(i-1, j-1), hup = H(i-1, j), fup = F(i-1, j),
// hleft = H(i, j-1), eleft = E(i, j-1); first_row selects the NEG F
// candidates of row 0.
struct Cell {
  float e_open, e_ext, e, f_open, f_ext, f, diag, h;
};

__device__ __forceinline__ Cell gotoh_cell(float s, float hdiag, float hup,
                                           float fup, float hleft,
                                           float eleft, bool first_row,
                                           float gi, float ge) {
  Cell c;
  c.e_open = hleft - gi;
  c.e_ext = eleft - ge;
  c.e = fmaxf(c.e_ext, c.e_open);
  c.f_open = first_row ? kNeg : hup - gi;
  c.f_ext = first_row ? kNeg : fup - ge;
  c.f = fmaxf(c.f_ext, c.f_open);
  c.diag = hdiag + s;
  c.h = fmaxf(fmaxf(c.diag, 0.0f), fmaxf(c.e, c.f));
  return c;
}

__device__ __forceinline__ void load_table(float* tab, const float* table,
                                           int a) {
  for (int k = threadIdx.x; k < a * a; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
}

// q_codes: (Q,) when q_lane == 0 (one query shared by every lane), or
// (Q, B) when q_lane == 1.  t_codes: (T, B).  hrow, frow: (T, B) scratch.
__global__ void sw_scores_kernel(const int32_t* __restrict__ q_codes,
                                 int q_lane,
                                 const int32_t* __restrict__ t_codes,
                                 const float* __restrict__ table, int a,
                                 const float* __restrict__ gap,
                                 float* __restrict__ hrow,
                                 float* __restrict__ frow,
                                 float* __restrict__ out, int q, int t,
                                 int b) {
  extern __shared__ float tab[];
  load_table(tab, table, a);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const float gi = gap[0];
  const float ge = gap[1];
  float best = 0.0f;
  for (int i = 0; i < q; ++i) {
    const int qc = q_codes[q_lane ? (size_t)i * b + lane : (size_t)i];
    const float* srow = tab + qc * a;
    const bool first_row = (i == 0);
    float hleft = 0.0f, eleft = kNeg, hdiag = 0.0f;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {
      const size_t idx = (size_t)j * b + lane;
      const float s = srow[t_codes[idx]];
      const float hup = first_row ? 0.0f : hrow[idx];
      const float fup = first_row ? kNeg : frow[idx];
      const Cell c = gotoh_cell(s, hdiag, hup, fup, hleft, eleft, first_row,
                                gi, ge);
      hrow[idx] = c.h;
      frow[idx] = c.f;
      best = fmaxf(best, c.h);
      hdiag = hup;
      hleft = c.h;
      eleft = c.e;
    }
  }
  out[lane] = best;
}

// tb: (Q+T-1, Q, B) int8, zeroed by the caller (only valid cells are
// written), tb[(i+j), i, b].  m, dat: (Q, B).
__global__ void sw_tb_kernel(const int32_t* __restrict__ q_codes, int q_lane,
                             const int32_t* __restrict__ t_codes,
                             const float* __restrict__ table, int a,
                             const float* __restrict__ gap,
                             float* __restrict__ hrow,
                             float* __restrict__ frow,
                             int8_t* __restrict__ tb, float* __restrict__ m,
                             int32_t* __restrict__ dat, int q, int t, int b) {
  extern __shared__ float tab[];
  load_table(tab, table, a);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const float gi = gap[0];
  const float ge = gap[1];
  for (int i = 0; i < q; ++i) {
    const int qc = q_codes[q_lane ? (size_t)i * b + lane : (size_t)i];
    const float* srow = tab + qc * a;
    const bool first_row = (i == 0);
    float hleft = 0.0f, eleft = kNeg, hdiag = 0.0f;
    float mrow = 0.0f;
    int32_t drow = 0;
    for (int j = 0; j < t; ++j) {
      const size_t idx = (size_t)j * b + lane;
      const float s = srow[t_codes[idx]];
      const float hup = first_row ? 0.0f : hrow[idx];
      const float fup = first_row ? kNeg : frow[idx];
      const Cell c = gotoh_cell(s, hdiag, hup, fup, hleft, eleft, first_row,
                                gi, ge);
      int code = c.h == 0.0f ? 0 : c.h == c.diag ? 1 : c.h == c.e ? 2 : 3;
      if (c.e_ext > c.e_open) code |= 4;
      if (c.f_ext > c.f_open) code |= 8;
      tb[((size_t)(i + j) * q + i) * b + lane] = (int8_t)code;
      if (c.h > mrow) {
        mrow = c.h;
        drow = i + j;
      }
      hrow[idx] = c.h;
      frow[idx] = c.f;
      hdiag = hup;
      hleft = c.h;
      eleft = c.e;
    }
    m[(size_t)i * b + lane] = mrow;
    dat[(size_t)i * b + lane] = drow;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  Each returns cudaGetLastError() of
// its launch (0 = cudaSuccess).

extern "C" int sw_scores_launch(const int32_t* q_codes, int q_lane,
                                const int32_t* t_codes, const float* table,
                                int a, const float* gap, float* hrow,
                                float* frow, float* out, int q, int t, int b,
                                void* stream) {
  const dim3 grid((b + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a * a * sizeof(float);
  sw_scores_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q_codes, q_lane, t_codes, table, a, gap, hrow, frow, out, q, t, b);
  return (int)cudaGetLastError();
}

extern "C" int sw_tb_launch(const int32_t* q_codes, int q_lane,
                            const int32_t* t_codes, const float* table, int a,
                            const float* gap, float* hrow, float* frow,
                            int8_t* tb, float* m, int32_t* dat, int q, int t,
                            int b, void* stream) {
  const dim3 grid((b + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a * a * sizeof(float);
  sw_tb_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q_codes, q_lane, t_codes, table, a, gap, hrow, frow, tb, m, dat, q, t,
      b);
  return (int)cudaGetLastError();
}
