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
// Design: an inter-thread wavefront, one warp per lane b (a query/template
// pair).  Thread k of the warp owns a stripe of R consecutive query rows,
// i0 = c0 + k*R .. i0 + R - 1, and keeps each row's H(i, j-1) and E(i, j-1)
// in registers.  Template column j reaches thread k at step j + k: the
// thread computes its R cells of column j top to bottom, then hands the
// stripe's last H and F (and the column's template code) to thread k + 1
// with __shfl_up_sync, which uses them at the next step as the row above
// its stripe.  Thread 0 takes the row above from the previous query chunk
// (c0 - 1), or the matrix edge in the first chunk.  A chunk holds 32*R
// rows; when Q is larger the warp walks the chunks in order and thread 31
// leaves the chunk's last row in a per-lane (B, T) scratch that thread 0
// of the next chunk reads, each value written once and read once.  The
// template codes, and that boundary row, come in blocks of 32 columns, one
// load per thread, and reach thread 0 by __shfl_sync.  The substitution
// table lives in shared memory.  K1's best score is a register max per
// thread, then a warp max reduction (max is exact in any order).  K2
// keeps each row's running max m and its anti-diagonal in registers and
// writes each cell's code straight to tb[(i+j), i, b].
//
// Exactness.  Every cell is built by gotoh_cell from the same operands in
// the same op order as the plain versions and the JAX twins (swaffine.py
// sw_affine_scores_xla :544 and sw_affine_tb_xla :584), so results are
// bit-equal to them for any gap values, fractional ones included:
//   * H outside the matrix is 0: the diagonal term at i==0 or j==0 is 0+s;
//   * E enters column 0 from NEG with H(i,-1)=0: E(i,0)=max(NEG-ge, 0-gi);
//   * both F candidates are NEG in row 0;
//   * H = max(max(diag, 0), max(E, F));
//   * K2's code: 0 if H==0, else 1 if H==diag, else 2 if H==E, else 3; then
//     |4 if e_ext > e_open and |8 if f_ext > f_open (strict);
//   * the running max per row updates on a strict >, and j increases with
//     the anti-diagonal d = i + j, so the first maximum wins as on the TPU.
// Rows past Q in the last chunk are computed but never counted or stored;
// they feed only rows below them.  Nothing is multiplied; the build still
// passes -fmad=false.
//
// What bounds it.  K1 does about 11 float add/sub/max per cell (1.34e9
// cells in a 512 x 512 x 5120 screen), plus a shared-memory table load, so
// it is bound by instruction issue, not by bytes: each step of a warp is a
// dependent chain of R cells, and the 5120 warps keep every SM's
// schedulers busy.  K2 has only a few lanes (one warp each, one SM each),
// so one warp's issue rate bounds it, and its byte stores: the 32 threads
// of a store write 32 different lines of tb.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.0e38f;  // swaffine.NEG; NEG - ge rounds back to NEG
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxR = 16;         // rows per thread for Q > 256

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

// Where a lane's output goes: K1 keeps the best score; K2 writes codes,
// row maxima and their anti-diagonals.
struct Lane {
  const int32_t* q_codes;  // (Q,) or (Q, B)
  int q_lane;
  const int32_t* t_codes;  // (T, B)
  const float* tab;        // (A, A), shared memory
  int a;
  float gi, ge;
  float* bnd_h;            // this lane's (T,) boundary row, or unused
  float* bnd_f;
  int8_t* tb;              // K2: (Q+T-1, Q, B)
  float* m;                // K2: (Q, B)
  int32_t* dat;            // K2: (Q, B)
  int q, t, b, lane;
};

// One query chunk of 32*R rows (rows from c0) over every template column.
// kPartial: the chunk runs past Q, so rows >= Q are neither counted nor
// stored.  Returns this thread's best H over its valid cells.
template <int R, bool kTb, bool kPartial>
__device__ __forceinline__ float run_chunk(const Lane& L, int c0,
                                           float best) {
  const int k = threadIdx.x & 31;
  const int i0 = c0 + k * R;
  const bool first_chunk = c0 == 0;
  const bool last_chunk = c0 + 32 * R >= L.q;
  const int nvalid = kPartial ? min(max(L.q - i0, 0), R) : R;

  int qoff[R];
  float hl[R], el[R];
  float mrow[kTb ? R : 1];
  int32_t drow[kTb ? R : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    int qc = 0;
    if (!kPartial || r < nvalid)
      qc = L.q_codes[L.q_lane ? (size_t)i * L.b + L.lane : (size_t)i];
    qoff[r] = qc * L.a;
    hl[r] = 0.0f;
    el[r] = kNeg;
    if constexpr (kTb) {
      mrow[r] = 0.0f;
      drow[r] = 0;
    }
  }

  // the row above the stripe at the previous column (the stripe's diag)
  float hd_prev = 0.0f;
  // this thread's last row at its latest column, and that column's code
  float h_out = 0.0f, f_out = kNeg;
  int t_out = 0;
  // thread k holds column blk + k of the template codes and of the
  // boundary row (the current block and the next one)
  int t_cur = 0, t_nxt = 0;
  float bh_cur = 0.0f, bh_nxt = 0.0f, bf_cur = kNeg, bf_nxt = kNeg;
  auto load_block = [&](int blk) {
    const int jj = blk + k;
    t_nxt = jj < L.t ? L.t_codes[(size_t)jj * L.b + L.lane] : 0;
    if (!first_chunk && jj < L.t) {
      bh_nxt = L.bnd_h[jj];
      bf_nxt = L.bnd_f[jj];
    }
  };
  load_block(0);

  const int steps = L.t + 31;
  for (int s = 0; s < steps; ++s) {
    const int jb = s & 31;
    if (jb == 0) {
      // orders the block loads of 32 steps ago before thread 31's stores
      // of those columns, which come 31 steps after their reads
      __syncwarp();
      t_cur = t_nxt;
      bh_cur = bh_nxt;
      bf_cur = bf_nxt;
      load_block(s + 32);
    }
    float h_up = __shfl_up_sync(kFull, h_out, 1);
    float f_up = __shfl_up_sync(kFull, f_out, 1);
    int t_col = __shfl_up_sync(kFull, t_out, 1);
    const int t0 = __shfl_sync(kFull, t_cur, jb);
    const float h0 = __shfl_sync(kFull, bh_cur, jb);
    const float f0 = __shfl_sync(kFull, bf_cur, jb);
    if (k == 0) {
      h_up = h0;      // first chunk: H(-1, j) = 0 (F is NEG via first_row)
      f_up = f0;
      t_col = t0;
    }
    const int j = s - k;
    if (j >= 0 && j < L.t) {
      const float* tcol = L.tab + t_col;
      float hd = hd_prev, hu = h_up, fu = f_up;
      // K2: cell (i0, j)'s code, then one anti-diagonal and one row on
      int8_t* tbp = nullptr;
      if constexpr (kTb)
        tbp = L.tb + ((size_t)(i0 + j) * L.q + i0) * L.b + L.lane;
      const size_t tb_step = (size_t)(L.q + 1) * L.b;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Cell c = gotoh_cell(tcol[qoff[r]], hd, hu, fu, hl[r], el[r],
                                  r == 0 && first_chunk && k == 0, L.gi,
                                  L.ge);
        const bool valid = !kPartial || r < nvalid;
        if constexpr (kTb) {
          if (valid) {
            const int i = i0 + r;
            int code = c.h == 0.0f ? 0 : c.h == c.diag ? 1
                                     : c.h == c.e      ? 2
                                                       : 3;
            if (c.e_ext > c.e_open) code |= 4;
            if (c.f_ext > c.f_open) code |= 8;
            *tbp = (int8_t)code;
            tbp += tb_step;
            if (c.h > mrow[r]) {
              mrow[r] = c.h;
              drow[r] = i + j;
            }
          }
        } else if (valid) {
          best = fmaxf(best, c.h);
        }
        hd = hl[r];
        hl[r] = c.h;
        el[r] = c.e;
        hu = c.h;
        fu = c.f;
      }
      h_out = hu;
      f_out = fu;
      t_out = t_col;
      if (k == 31 && !last_chunk) {
        L.bnd_h[j] = hu;
        L.bnd_f[j] = fu;
      }
    }
    hd_prev = h_up;
  }
  // the next chunk reads what thread 31 stored
  __syncwarp();
  if constexpr (kTb) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!kPartial || r < nvalid) {
        const size_t o = (size_t)(i0 + r) * L.b + L.lane;
        L.m[o] = mrow[r];
        L.dat[o] = drow[r];
      }
    }
  }
  return best;
}

template <int R, bool kTb>
__device__ __forceinline__ float run_lane(const Lane& L) {
  float best = 0.0f;
  for (int c0 = 0; c0 < L.q; c0 += 32 * R) {
    if (c0 + 32 * R <= L.q)
      best = run_chunk<R, kTb, false>(L, c0, best);
    else
      best = run_chunk<R, kTb, true>(L, c0, best);
  }
  return best;
}

__device__ __forceinline__ void load_table(float* tab, const float* table,
                                           int a) {
  for (int k = threadIdx.x; k < a * a; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
}

// One warp per block, one lane per warp.  q_codes: (Q,) when q_lane == 0
// (one query shared by every lane), or (Q, B) when q_lane == 1.  t_codes:
// (T, B).  bnd_h, bnd_f: (B, T) scratch, used only when Q > 32*R.
template <int R>
__global__ void __launch_bounds__(32)
    sw_scores_kernel(const int32_t* __restrict__ q_codes, int q_lane,
                     const int32_t* __restrict__ t_codes,
                     const float* __restrict__ table, int a,
                     const float* __restrict__ gap, float* __restrict__ bnd_h,
                     float* __restrict__ bnd_f, float* __restrict__ out,
                     int q, int t, int b) {
  extern __shared__ float tab[];
  load_table(tab, table, a);
  const int lane = blockIdx.x;
  const Lane L{q_codes, q_lane, t_codes, tab, a, gap[0], gap[1],
               bnd_h + (size_t)lane * t, bnd_f + (size_t)lane * t,
               nullptr, nullptr, nullptr, q, t, b, lane};
  float best = run_lane<R, false>(L);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  if (threadIdx.x == 0) out[lane] = best;
}

// tb: (Q+T-1, Q, B) int8, zeroed by the caller (only valid cells are
// written), tb[(i+j), i, b].  m, dat: (Q, B).
template <int R>
__global__ void __launch_bounds__(32)
    sw_tb_kernel(const int32_t* __restrict__ q_codes, int q_lane,
                 const int32_t* __restrict__ t_codes,
                 const float* __restrict__ table, int a,
                 const float* __restrict__ gap, float* __restrict__ bnd_h,
                 float* __restrict__ bnd_f, int8_t* __restrict__ tb,
                 float* __restrict__ m, int32_t* __restrict__ dat, int q,
                 int t, int b) {
  extern __shared__ float tab[];
  load_table(tab, table, a);
  const int lane = blockIdx.x;
  const Lane L{q_codes, q_lane, t_codes, tab, a, gap[0], gap[1],
               bnd_h + (size_t)lane * t, bnd_f + (size_t)lane * t,
               tb, m, dat, q, t, b, lane};
  run_lane<R, true>(L);
}

// Rows per thread: the fewest that cover Q in one chunk, at most kMaxR.
int rows_per_thread(int q) {
  int r = 1;
  while (r < kMaxR && 32 * r < q) r *= 2;
  return r;
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  bnd_h and bnd_f hold B*T floats each
// when Q > sw_rows_per_warp(), and are not touched otherwise.  Each
// returns cudaGetLastError() of its launch (0 = cudaSuccess).

extern "C" int sw_rows_per_warp(void) { return 32 * kMaxR; }

#define SW_DISPATCH(KERNEL, ...)                                          \
  do {                                                                    \
    const dim3 grid(b);                                                   \
    const size_t smem = (size_t)a * a * sizeof(float);                    \
    cudaStream_t st = (cudaStream_t)stream;                               \
    switch (rows_per_thread(q)) {                                         \
      case 1: KERNEL<1><<<grid, 32, smem, st>>>(__VA_ARGS__); break;      \
      case 2: KERNEL<2><<<grid, 32, smem, st>>>(__VA_ARGS__); break;      \
      case 4: KERNEL<4><<<grid, 32, smem, st>>>(__VA_ARGS__); break;      \
      case 8: KERNEL<8><<<grid, 32, smem, st>>>(__VA_ARGS__); break;      \
      default: KERNEL<kMaxR><<<grid, 32, smem, st>>>(__VA_ARGS__); break; \
    }                                                                     \
  } while (0)

extern "C" int sw_scores_launch(const int32_t* q_codes, int q_lane,
                                const int32_t* t_codes, const float* table,
                                int a, const float* gap, float* bnd_h,
                                float* bnd_f, float* out, int q, int t, int b,
                                void* stream) {
  SW_DISPATCH(sw_scores_kernel, q_codes, q_lane, t_codes, table, a, gap,
              bnd_h, bnd_f, out, q, t, b);
  return (int)cudaGetLastError();
}

extern "C" int sw_tb_launch(const int32_t* q_codes, int q_lane,
                            const int32_t* t_codes, const float* table, int a,
                            const float* gap, float* bnd_h, float* bnd_f,
                            int8_t* tb, float* m, int32_t* dat, int q, int t,
                            int b, void* stream) {
  SW_DISPATCH(sw_tb_kernel, q_codes, q_lane, t_codes, table, a, gap, bnd_h,
              bnd_f, tb, m, dat, q, t, b);
  return (int)cudaGetLastError();
}
