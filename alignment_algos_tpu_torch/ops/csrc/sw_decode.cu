// Traceback decode of K2's codes for Hopper (sm_90a).
//
//   K8 sw_decode_kernel -> per lane b: the best local score (the first
//      maximum of m[:q, b]) and the walk of the Gotoh traceback from that
//      cell, recording each matched (i, j) at the step that matched it.
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
// Design: one thread per lane, 32 threads per block.  A thread scans its
// lane's column of m with a strict > over ascending rows (the first
// maximum, as torch.argmax and jnp.argmax; a NaN wins as they let it),
// then walks the step body of the reference loop as scalar code in
// registers: the H/E/F state, the stop code, the match, and the E/F
// transitions that consume a template column or a query row in the same
// step and leave the gap state on the current cell's bits 2/3.  Each step
// reads one byte of tb.  The step counter advances exactly as the loop's:
// a gap step records -1, so records are position-for-position equal.  A
// lane that dies (off the matrix edge, a stop code, or a best score not
// above 0) never revives, so its thread leaves the walk and writes -1 for
// its remaining steps.  Offsets into tb are 64-bit: at 512 x 512 x 5120
// it holds 2.68e9 bytes.  Reads clamp (i+j, i) into tb as the reference
// does, so the kernel is the reference's function on any input.
//
// What bounds it.  The bytes are few (the codes a walk touches, m and dat
// once, the records), but each step's address depends on the code the
// previous step read: a walk is a chain of dependent loads, at best one
// L2 hit (K2 just wrote tb, 5.2 MB at 512 x 512 x 10, into the 50 MB L2)
// per step.  So the longest walk's length times the L2 latency bounds it,
// far above its bytes over the memory rate; the lanes' walks run side by
// side, one thread each.  No host sync: the caller's pull of the outputs
// is the only one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    sw_decode_kernel(const int8_t* __restrict__ tb,
                     const float* __restrict__ m,
                     const int32_t* __restrict__ dat,
                     float* __restrict__ scores, int32_t* __restrict__ rec_i,
                     int32_t* __restrict__ rec_j, int q, int t, int b, int nd,
                     int qp, int ldb, int ldm) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= b) return;

  // the first maximum of m[:q, lane]
  float best = __ldg(m + lane);
  int bi = 0;
#pragma unroll 8
  for (int r = 1; r < q; ++r) {
    const float v = __ldg(m + (size_t)r * ldm + lane);
    if (v > best || (isnan(v) && !isnan(best))) {
      best = v;
      bi = r;
    }
  }
  scores[lane] = best;

  // the walk from (bi, dat[bi] - bi); 64-bit (i, j) as the reference's
  long long i = bi;
  long long j = (long long)__ldg(dat + (size_t)bi * ldm + lane) - bi;
  const int max_steps = q + t + 2;
  int step = 0;
  if (best > 0.0f) {
    int state = 0;  // 0 = H, 1 = E, 2 = F
    for (; step < max_steps; ++step) {
      if (i < 0 || j < 0) break;  // off the matrix: this step records -1
      const long long d0 = min(i + j, (long long)nd - 1);
      const long long i0 = min(i, (long long)qp - 1);
      const int c = __ldg(tb + ((size_t)d0 * qp + (size_t)i0) * ldb + lane);
      int ri = -1, rj = -1;
      if (state == 0) {
        const int hb = c & 3;
        if (hb == 0) break;  // stop code: this step records -1
        if (hb == 1) {       // match: record, then one cell up the diagonal
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
      rec_i[(size_t)step * b + lane] = ri;
      rec_j[(size_t)step * b + lane] = rj;
    }
  }
  for (; step < max_steps; ++step) {
    rec_i[(size_t)step * b + lane] = -1;
    rec_j[(size_t)step * b + lane] = -1;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  tb is (nd, qp, ldb); m and dat have
// ldm columns and at least q rows; b <= min(ldb, ldm).  Returns
// cudaGetLastError() of the launch (0 = cudaSuccess).
extern "C" int sw_decode_launch(const int8_t* tb, const float* m,
                                const int32_t* dat, float* scores,
                                int32_t* rec_i, int32_t* rec_j, int q, int t,
                                int b, int nd, int qp, int ldb, int ldm,
                                void* stream) {
  const dim3 grid((b + kThreads - 1) / kThreads);
  sw_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tb, m, dat, scores, rec_i, rec_j, q, t, b, nd, qp, ldb, ldm);
  return (int)cudaGetLastError();
}
