// Traceback decode of K2's codes for Hopper (sm_90a).
//
//   K8 sw_decode -> per lane b: the best local score (the first maximum of
//      m[:q, b]) and the walk of the Gotoh traceback from that cell,
//      recording each matched (i, j) at the step that matched it.
//      Replaces alignment_algos_tpu/ops/swaffine.py _decode_tb_device
//      (:387), a jitted lax.fori_loop of XLA device code (not a Pallas
//      kernel); the port's plain version is swaffine.decode_tb_plain.
//
// Inputs as K2 leaves them: tb (ND, QP, LDB) int8 with tb[i+j, i, b] the
// code of cell (i, j) (bits 0-1: 0 stop, 1 diagonal, 2 from E, 3 from F;
// bit 2: E extended, bit 3: F extended), m and dat (>= q rows, LDM
// columns): the per-row running max and its anti-diagonal.  Outputs:
// scores (B,) float32, rec_i and rec_j (q + t + 2, B) int32, -1 wherever
// the step matched nothing (gap steps, stopped lanes).
//
// Both modes run the reference loop's step body as scalar code (Walk): the
// H/E/F state, the stop code, the match, and the E/F transitions that
// consume a template column or a query row in the same step and leave the
// gap state on the current cell's bits 2/3.  The step counter advances
// exactly as the loop's: a gap step records -1, so records are
// position-for-position equal.  A lane that dies (off the matrix edge, a
// stop code, or a best score not above 0) never revives, so its remaining
// steps record -1.  The first maximum is the reference's (torch.argmax,
// jnp.argmax): a NaN beats any number, a larger value beats a smaller, and
// of equal values the lower row wins with its own bits (-0.0 before +0.0
// stays -0.0).  Offsets into tb are 64-bit: at 512 x 512 x 5120 it holds
// 2.68e9 bytes.  Reads clamp (i+j, i) into tb as the reference does, so
// the kernel is the reference's function on any input.
//
// What bounds it.  The bytes are few (the codes a walk touches, m and dat
// once, the records), but each step's address depends on the code the
// previous step read: a walk is a chain of dependent loads, and read from
// device memory each link waits an L2 hit (K2 just wrote tb, 5.2 MB at
// 512 x 512 x 10, into the 50 MB L2), about 0.5 us: 470 steps took 0.25
// ms.  Two modes (swaffine.k8_plan picks one from the lane count):
//   * windowed (few lanes, the screen's top 10): one block per lane.  Its
//     threads split the scan of m and meet in a reduction, then stage a
//     window of the lane's codes in shared memory, kDw anti-diagonals x
//     kIw rows in tb's own (d = i+j, i) coordinates ending at the walk's
//     current cell, each warp loading anti-diagonals with its threads on
//     consecutive rows (independent loads: one latency a window, not one a
//     step).  One thread walks the window from shared memory in 32-bit
//     window coordinates, a step of selects and one branch, reading the
//     codes of the three cells it may move to while it decides, and keeps
//     the window's records in shared memory; when the walk leaves it,
//     through its d-edge or its i-edge, the block writes those records
//     out and loads the next window there.  A match step lowers d by 2
//     and i by 1, so a 64 x 32 window holds about 32 steps.
//   * lane (many lanes): one thread per lane walks, reading device memory
//     each step, after the block's 8 warps have split the scan of m for
//     its 32 lanes.  Windows would multiply the traffic there: once LDB >=
//     32 every cell of a window is its own 32-byte sector, against one
//     sector a step, and the lanes' chains already run side by side.
// No host sync: the caller's pull of the outputs is the only one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLaneThreads = 32;   // lane mode: lanes a block
constexpr int kWinThreads = 256;   // threads a block, both modes
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kDw = 64;            // anti-diagonals of a window
constexpr int kIw = 32;            // rows of a window: one a thread of a warp
constexpr int kNone = 0x7fffffff;  // the row of an empty scan part

// A candidate of the first-maximum scan: the value at row r.
struct Best {
  float v;
  int r;
};

// The reference's first maximum of two candidates: a NaN wins, then the
// larger value, then the lower row (its value kept, bits and all).  Order
// free, so the rows may be scanned in parts and the parts met in any order.
__device__ __forceinline__ Best first_max(Best a, Best b) {
  if (b.r == kNone) return a;
  if (a.r == kNone) return b;
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an != bn) return an ? a : b;
  if (!an && a.v != b.v) return a.v > b.v ? a : b;
  return a.r < b.r ? a : b;
}

// A walk's cell (64-bit, as the reference's (i, j)) and state.
struct Walk {
  long long i, j;
  int state;  // 0 = H, 1 = E, 2 = F

  // tb's (anti-diagonal, row) of the current cell, clamped as the
  // reference clamps its reads (i, j >= 0 here)
  __device__ __forceinline__ int d0(int nd) const {
    return (int)min(i + j, (long long)nd - 1);
  }
  __device__ __forceinline__ int i0(int qp) const {
    return (int)min(i, (long long)qp - 1);
  }

  // One step of the reference loop on the current cell's code c: false on
  // a stop code (the step records -1 and the lane dies), else the step's
  // record (ri, rj), -1 unless it matched.
  __device__ __forceinline__ bool step(int c, int& ri, int& rj) {
    ri = rj = -1;
    if (state == 0) {
      const int hb = c & 3;
      if (hb == 0) return false;
      if (hb == 1) {  // match: record, then one cell up the diagonal
        ri = (int)i;
        rj = (int)j;
        --i;
        --j;
      } else if (hb == 2) {  // into E: consumes column j now
        state = (c & 4) ? 1 : 0;
        --j;
      } else {  // into F: consumes row i now
        state = (c & 8) ? 2 : 0;
        --i;
      }
    } else if (state == 1) {  // in E: leaves it when the open bit won
      if (!(c & 4)) state = 0;
      --j;
    } else {  // in F
      if (!(c & 8)) state = 0;
      --i;
    }
    return true;
  }
};

// The lane mode: a block decodes 32 lanes.  Its 8 warps split the scan of
// m's rows (each warp every 8th row, its threads the 32 lanes) and meet in
// shared memory; then warp 0 walks, one thread a lane.
__global__ void __launch_bounds__(kWinThreads)
    sw_decode_lane_kernel(const int8_t* __restrict__ tb,
                          const float* __restrict__ m,
                          const int32_t* __restrict__ dat,
                          float* __restrict__ scores,
                          int32_t* __restrict__ rec_i,
                          int32_t* __restrict__ rec_j, int q, int t, int b,
                          int nd, int qp, int ldb, int ldm) {
  __shared__ Best part[kWinWarps][kLaneThreads];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int lane = blockIdx.x * kLaneThreads + wl;
  // the first maximum of m[:q, lane]: 8 of a warp's rows loaded, then
  // folded in order
  Best best{0.0f, kNone};
  if (lane < b) {
    for (int r0 = warp; r0 < q; r0 += 8 * kWinWarps) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + k * kWinWarps;
        v[k] = r < q ? __ldg(m + (size_t)r * ldm + lane) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (r0 + k * kWinWarps < q)
          best = first_max(best, Best{v[k], r0 + k * kWinWarps});
    }
  }
  part[warp][wl] = best;
  __syncthreads();
  if (warp != 0 || lane >= b) return;
  for (int k = 1; k < kWinWarps; ++k) best = first_max(best, part[k][wl]);
  scores[lane] = best.v;

  const int max_steps = q + t + 2;
  int step = 0;
  if (best.v > 0.0f) {
    Walk w{best.r, (long long)__ldg(dat + (size_t)best.r * ldm + lane) -
                       best.r,
           0};
    for (; step < max_steps; ++step) {
      if (w.i < 0 || w.j < 0) break;  // off the matrix: this step records -1
      const int c = __ldg(tb + ((size_t)w.d0(nd) * qp + w.i0(qp)) * ldb +
                          lane);
      int ri, rj;
      if (!w.step(c, ri, rj)) break;
      rec_i[(size_t)step * b + lane] = ri;
      rec_j[(size_t)step * b + lane] = rj;
    }
  }
  for (; step < max_steps; ++step) {
    rec_i[(size_t)step * b + lane] = -1;
    rec_j[(size_t)step * b + lane] = -1;
  }
}

// The windowed mode: block blockIdx.x decodes lane blockIdx.x; windows of
// dw x iw codes (the plan's: kDw x kIw, clipped to ND x QP).
__global__ void __launch_bounds__(kWinThreads)
    sw_decode_window_kernel(const int8_t* __restrict__ tb,
                            const float* __restrict__ m,
                            const int32_t* __restrict__ dat,
                            float* __restrict__ scores,
                            int32_t* __restrict__ rec_i,
                            int32_t* __restrict__ rec_j, int q, int t, int b,
                            int nd, int qp, int ldb, int ldm, int dw,
                            int iw) {
  __shared__ int8_t win[kDw * kIw];  // win[(d_hi - d) * kIw + (i_hi - i)]
  __shared__ int wrec[2][kDw];       // the records of a window's steps
  __shared__ Best part[kWinWarps];
  __shared__ int next_d, next_i, seg0, seg1;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;

  // the first maximum of m[:q, lane]: a strided part a thread, met in the
  // warp, then across the warps
  Best best{0.0f, kNone};
  for (int r = tid; r < q; r += kWinThreads)
    best = first_max(best, Best{__ldg(m + (size_t)r * ldm + lane), r});
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_down_sync(0xffffffffu, best.v, off),
                 __shfl_down_sync(0xffffffffu, best.r, off)};
    best = first_max(best, o);
  }
  if (wl == 0) part[warp] = best;
  __syncthreads();

  // thread 0 walks.  Where dat puts the start past tb's last anti-diagonal
  // (or QP is below q), the reads clamp: those first steps read device
  // memory as the lane mode does.  From the first cell inside tb on, the
  // walk stays inside (i and j only fall), its (i, j) fit 32 bits, and it
  // runs from the window it holds, anti-diagonals (wd - dw, wd] x rows
  // (wi - iw, wi] (none at first), in window coordinates (dd, ii) = (wd -
  // d, wi - i).  A step lowers d by 1 or 2, so a window holds at most dw
  // steps; their records go to shared memory and the block writes them
  // out after the window.
  const int max_steps = q + t + 2;
  int step = 0, i = 0, j = 0, st = 0, wd = -1, wi = -1;
  bool alive = false;
  if (tid == 0) {
    for (int k = 1; k < kWinWarps; ++k) best = first_max(best, part[k]);
    scores[lane] = best.v;
    if (best.v > 0.0f) {
      Walk w{best.r,
             (long long)__ldg(dat + (size_t)best.r * ldm + lane) - best.r,
             0};
      alive = true;
      for (; step < max_steps; ++step) {
        if (w.i < 0 || w.j < 0) {  // off the matrix: this step records -1
          alive = false;
          break;
        }
        if (w.i + w.j < nd && w.i < qp) break;  // inside tb from here on
        const int c = __ldg(tb + ((size_t)w.d0(nd) * qp + w.i0(qp)) * ldb +
                            lane);
        int ri, rj;
        if (!w.step(c, ri, rj)) {
          alive = false;
          break;
        }
        rec_i[(size_t)step * b + lane] = ri;
        rec_j[(size_t)step * b + lane] = rj;
      }
      i = (int)w.i;
      j = (int)w.j;
      st = w.state;
    }
  }
  constexpr int kLast = kDw * kIw - 1;
  for (;;) {
    if (tid == 0) {
      int need_d = -1, need_i = -1;
      const int s0 = step;
      int dd = wd - (i + j), ii = wi - i;
      if (alive && step < max_steps &&
          ((unsigned)dd >= (unsigned)dw || (unsigned)ii >= (unsigned)iw)) {
        need_d = i + j;  // the walk's cell is past the window (or none yet)
        need_i = i;
      } else if (alive && step < max_steps) {
        // each step computes its successor unconditionally and leaves the
        // loop by one branch on every exit at once (a stop, the last step,
        // off the matrix, off the window): a branch costs the lone walking
        // thread more than the arithmetic
        int c = win[dd * kIw + ii];
        bool stop, match, e, f;
        int ni, nj, ndd, nii;
        for (;;) {
          // the three cells the step may move to, read while it decides
          const int at = dd * kIw + ii;
          const int cm = win[min(at + 2 * kIw + 1, kLast)];  // match
          const int ce = win[min(at + kIw, kLast)];          // E
          const int cf = win[min(at + kIw + 1, kLast)];      // F
          const int hb = c & 3;
          const bool h = st == 0;
          stop = h && hb == 0;
          match = h && hb == 1;
          e = st == 1 || (h && hb == 2);  // consumes column j
          f = st == 2 || (h && hb == 3);  // consumes row i
          wrec[0][step - s0] = match ? i : -1;  // unused after a stop
          wrec[1][step - s0] = match ? j : -1;
          ni = i - (match || f);
          nj = j - (match || e);
          ndd = dd + (match ? 2 : 1);
          nii = ii + (match || f);
          if (stop || step + 1 >= max_steps || (ni | nj) < 0 || ndd >= dw ||
              nii >= iw)
            break;
          ++step;
          i = ni;
          j = nj;
          // a gap state stays while its cell's extension bit is set
          st = e ? (c >> 2) & 1 : f ? (c >> 2) & 2 : 0;
          dd = ndd;
          ii = nii;
          c = match ? cm : e ? ce : cf;
        }
        if (stop) {  // stop code: this step records -1
          alive = false;
        } else {
          ++step;
          i = ni;
          j = nj;
          st = e ? (c >> 2) & 1 : f ? (c >> 2) & 2 : 0;
          if (step >= max_steps) {
          } else if ((i | j) < 0) {  // off the matrix: this step records -1
            alive = false;
          } else {  // through the d-edge, the i-edge or both at once
            need_d = i + j;
            need_i = i;
          }
        }
      }
      next_d = need_d;
      next_i = need_i;
      seg0 = s0;
      seg1 = step;
      wd = need_d;
      wi = need_i;
    }
    __syncthreads();
    for (int k = tid; k < seg1 - seg0; k += kWinThreads) {
      rec_i[(size_t)(seg0 + k) * b + lane] = wrec[0][k];
      rec_j[(size_t)(seg0 + k) * b + lane] = wrec[1][k];
    }
    const int d_hi = next_d, i_hi = next_i;
    if (d_hi < 0) break;
    // the window ending at (d_hi, i_hi): warp k loads anti-diagonals
    // d_hi - k, d_hi - k - 8, ..., its threads consecutive rows (addresses
    // LDB apart), every load issued before any is stored
    int8_t code[kDw / kWinWarps];
#pragma unroll
    for (int k = 0; k < kDw / kWinWarps; ++k) {
      const int dd = warp + k * kWinWarps;
      const int d = d_hi - dd, r = i_hi - wl;
      code[k] = (dd < dw && wl < iw && d >= 0 && r >= 0)
                    ? __ldg(tb + ((size_t)d * qp + r) * ldb + lane)
                    : (int8_t)0;
    }
#pragma unroll
    for (int k = 0; k < kDw / kWinWarps; ++k)
      win[(warp + k * kWinWarps) * kIw + wl] = code[k];
    __syncthreads();
  }
  // the steps past the walk's end record -1, the whole block writing
  for (int s = seg1 + tid; s < max_steps; s += kWinThreads) {
    rec_i[(size_t)s * b + lane] = -1;
    rec_j[(size_t)s * b + lane] = -1;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  tb is (nd, qp, ldb); m and dat have
// ldm columns and at least q rows; b <= min(ldb, ldm).  The plan
// (swaffine.k8_plan) is mode 0 (lane; dw = iw = 0) or 1 (windowed; dw =
// min(kDw, nd), iw = min(kIw, qp)).  Returns cudaGetLastError() of the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for shapes or a plan
// that do not match.
extern "C" int sw_decode_launch(const int8_t* tb, const float* m,
                                const int32_t* dat, float* scores,
                                int32_t* rec_i, int32_t* rec_j, int q, int t,
                                int b, int nd, int qp, int ldb, int ldm,
                                int mode, int dw, int iw, void* stream) {
  if (q < 1 || t < 1 || b < 1 || nd < 1 || qp < 1 || b > ldb || b > ldm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0 && dw == 0 && iw == 0) {
    sw_decode_lane_kernel<<<(b + kLaneThreads - 1) / kLaneThreads,
                            kWinThreads, 0, st>>>(
        tb, m, dat, scores, rec_i, rec_j, q, t, b, nd, qp, ldb, ldm);
  } else if (mode == 1 && dw == min(kDw, nd) && iw == min(kIw, qp)) {
    sw_decode_window_kernel<<<b, kWinThreads, 0, st>>>(
        tb, m, dat, scores, rec_i, rec_j, q, t, b, nd, qp, ldb, ldm, dw, iw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
