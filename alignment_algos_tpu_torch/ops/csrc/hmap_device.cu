// Device HMAP similarity producer for Hopper (sm_90a): two kernels.
//
//   K5 hmap_sim_kernel replaces alignment_algos_tpu/ops/hmap_device.py
//      build_similarity_device (:137) up to the z-norm: the raw
//      similarity ip * expf(((alpha * pc) * conf_q) * conf_t) with
//      nan_to_num and zeroed borders.  One host call launches it over
//      every pair of a screen, each pair described by a SimPair.
//   K6 hmap_znorm_kernel replaces _znorm_scalars (:172) and the rest of
//      build_similarity_device: the mean and standard deviation of the
//      [1, q2-1) x [1, t2-1) region as a strictly serial float32 chain in
//      row-major order, then (S - avg) / std + zero_shift inside the
//      region (only + zero_shift when not normalizing), 0 on the borders.
//      One host call launches its two passes (stats, apply) over every
//      pair of a screen, each pair described by a ZPair.
// Neither is a Pallas kernel on the TPU (XLA code with binary64 emulated on
// uint32 pairs); on the card the arithmetic is native.
//
// Exactness (bit-equal to HMAPaliEval.build_costs' S, the host path):
//   * every dot product is a serial multiply-then-add chain in k, as
//     utils/hmath.seq_matmul_f32; the build passes -fmad=false, so no
//     multiply and add are contracted anywhere in this file;
//   * pc = dot3 / 3 and the z-norm's divisions are IEEE float32 division
//     (/ under nvcc's default -prec-div=true, and __fdiv_rn), the square
//     root __fsqrt_rn, all correctly rounded, so sf64's integer-corrected
//     div32 and sqrt32 have no counterpart;
//   * expf is a replica of glibc 2.36 __expf_fma (the libm the host path
//     calls) in native float64 with __fma_rn at exactly the sites where that
//     build fuses (ops/sf64.py expf_bits, :444-457), on finite |x| < 87;
//     beyond, +inf (x > 0) or +0, and NaN passes through (the domain rule of
//     hmap_device._expf_ieee, the reference's documented 87-88 deviation);
//   * the z-norm sums are one serial chain per pair: torch.sum and
//     torch.cumsum accumulate in another order and round differently.
//
// What bounds them.  K5: per interior cell 23 multiply-adds, the division,
// three multiplies and one float64 expf (about 51 float32 and 10 float64
// operations), and 4 bytes of S written: operations, by a little.  So a
// block computes 64 columns of one pair, every row: its template columns
// (profile, SSE z-rows, confidences) staged in shared memory once,
// transposed and padded, then the query's rows 32 at a time, and each
// thread keeps a 4 x 2 micro-tile in registers: per k one broadcast
// 16-byte load of its four query values and two conflict-free loads of
// its template values feed 8 multiply-adds, where one thread per cell read
// 48 floats from device memory.  A block finds its pair by a binary search
// over the descriptors' first tiles (none a cell, no divide a cell).
// K6's stats pass is one dependent chain per pair (the order is the
// contract): a screen's time is at least its longest region times one
// float32 add's latency.  So all pairs run at once, one warp each, in one
// launch, and the chain reads shared memory that cp.async filled chunks
// ahead, so it never waits on device memory; the apply pass is elementwise
// and bound by bytes (S read, out written).  Measured on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: K6 0.79 ms for a 1024-template profile screen in one launch
// (stats 0.52 ms, apply 0.26 ms; 253 launches took 431 ms before), 0.30 ms
// for the 258 x 258 bucket alone: the chain runs about 9 cycles an
// element, against 4 for its adds alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltMax = 3.40282347e+38f;

// glibc 2.36 __expf_fma constants (ops/sf64.py :419-439)
constexpr double kInvLn2N = 0x1.71547652b82fep+5;
constexpr double kShift = 0x1.8p+52;
constexpr double kC0 = 0x1.c6af84b912394p-20;
constexpr double kC1 = 0x1.ebfce50fac4f3p-13;
constexpr double kC2 = 0x1.62e42ff0c52d6p-6;

// tab[i] = bits(2^(i/32)) - (i << 47)
__constant__ uint64_t kTab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull,
};

// glibc's main path (e_expf.c): z = InvLn2N * x; k = round(z);
// r = z - k; s = 2^(k/32); y = s * (C0 r^3 + C1 r^2 + C2 r + 1).  tab is
// kTab staged in shared memory: a warp's 32 indices differ, and constant
// memory would serve them one address at a time.
__device__ __forceinline__ float expf_replica(float x,
                                              const uint64_t* tab) {
  const double xd = (double)x;
  const double zs = __fma_rn(kInvLn2N, xd, kShift);
  const uint64_t ki = (uint64_t)__double_as_longlong(zs);
  const double kd = __dsub_rn(zs, kShift);
  const double r = __fma_rn(kInvLn2N, xd, -kd);
  const uint64_t t = tab[ki % 32] + (ki << 47);
  const double s = __longlong_as_double((long long)t);
  const double z2 = __fma_rn(kC0, r, kC1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(kC2, r, 1.0);
  y = __fma_rn(z2, r2, y);
  y = __dmul_rn(y, s);
  return __double2float_rn(y);
}

__device__ __forceinline__ float expf_domain(float x, const uint64_t* tab) {
  if (x != x) return x;
  if (fabsf(x) < 87.0f) return expf_replica(x, tab);
  return x > 0.0f ? __int_as_float(0x7f800000) : 0.0f;
}

// ------------------------------------------------------------------ K5
//
// One pair of a K5 launch (40 bytes; ops/hmap_device.SIM_PAIR_DTYPE mirrors
// it): its template rows t_aa (t2, ka), t_zsse (t2, ks) and t_conf (t2,),
// its raw similarity S (q2, t2), all row-major, t2, and its first tile (a
// tile is kTileT columns of the pair, every row).
struct SimPair {
  const float* t_aa;
  const float* t_zsse;
  const float* t_conf;
  float* S;
  int32_t t2, tile0;
};

constexpr int kTileQ = 32;                         // query rows a pass
constexpr int kTileT = 64;                         // template columns
constexpr int kSimWarps = kThreads / 32;
constexpr int kRowsPerThread = kTileQ / kSimWarps;  // 4: one 16-byte load
constexpr int kLdQ = kTileQ + 4;  // staged query k-row: 16-byte aligned
constexpr int kLdT = kTileT + 1;  // staged template k-row: bank-skewed
constexpr int kSimSmemMax = 48 * 1024;

// dst[(k0 + k) * ld + r] = src[r * width + k] for r < rows, k < width: the
// rows read as one contiguous run, stored transposed (a k-row per feature).
__device__ __forceinline__ void stage_rows(float* dst, int ld, int k0,
                                           const float* __restrict__ src,
                                           int width, int rows) {
  const int total = rows * width;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / width;  // 32-bit, once per staged value and block
    dst[(k0 + e - r * width) * ld + r] = __ldg(src + e);
  }
}

// The cells (i0 + warp * 4 + r, j0 + lane + 32 c), c < C, of a pass: both
// dot chains in k order, each started as a product (fl(0 + x) would turn
// -0.0 into +0.0), then the scalar tail, written to S unless off the pair.
template <int C>
__device__ __forceinline__ void sim_cells(const float* __restrict__ sq,
                                          const float* __restrict__ st,
                                          const uint64_t* tab, int ka,
                                          int ks, float alpha,
                                          float* __restrict__ S, int q2,
                                          int t2, int i0, int j0) {
  constexpr int R = kRowsPerThread;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * R;
  float ip[R][C], dot[R][C];
  float a[R], b[C];
  auto load = [&](int k) {
    const float4 v = *reinterpret_cast<const float4*>(sq + k * kLdQ + r0);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = st[k * kLdT + lane + 32 * c];
  };
  load(0);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) ip[r][c] = a[r] * b[c];
#pragma unroll 4
  for (int k = 1; k < ka; ++k) {
    load(k);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) ip[r][c] = ip[r][c] + a[r] * b[c];
  }
  load(ka);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dot[r][c] = a[r] * b[c];
  for (int k = ka + 1; k < ka + ks; ++k) {
    load(k);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) dot[r][c] = dot[r][c] + a[r] * b[c];
  }
  load(ka + ks);  // the confidences
  const float ksf = (float)ks;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + lane + 32 * c;
      if (i >= q2 || j >= t2) continue;
      float v = 0.0f;
      if (i != 0 && i != q2 - 1 && j != 0 && j != t2 - 1) {
        const float pc = dot[r][c] / ksf;
        float arg = alpha * pc;
        arg = arg * a[r];
        arg = arg * b[c];
        const float x = ip[r][c] * expf_domain(arg, tab);
        v = fabsf(x) <= kFltMax ? x : 0.0f;  // nan_to_num: NaN, +-inf -> 0
      }
      S[(size_t)i * t2 + j] = v;
    }
  }
}

// One tile of one pair per block: its kTileT template columns staged once,
// then every row of S in passes of kTileQ query rows.  The query comes
// transposed, qt (ka + ks + 1, q2): its profile, SSE z-rows and
// confidences as k-rows, so a pass stages it with coalesced loads and no
// division.  The pair is the last whose first tile is at or below the
// block.
__global__ void __launch_bounds__(kThreads, 5)
    hmap_sim_kernel(const SimPair* __restrict__ pairs, int n,
                    const float* __restrict__ qt, int q2, int ka, int ks,
                    float alpha) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t tab[32];
  const int w = ka + ks + 1;    // features a row: profile, SSE, confidence
  float* sq = smem;             // w x kLdQ
  float* st = smem + w * kLdQ;  // w x kLdT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 32) tab[threadIdx.x] = kTab[threadIdx.x];
  const int blk = blockIdx.x;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pairs[mid].tile0 <= blk) lo = mid;
    else hi = mid - 1;
  }
  const SimPair pr = pairs[lo];
  const int t2 = pr.t2;
  const int j0 = (blk - pr.tile0) * kTileT;
  const int nt = min(kTileT, t2 - j0);
  stage_rows(st, kLdT, 0, pr.t_aa + (size_t)j0 * ka, ka, nt);
  stage_rows(st, kLdT, ka, pr.t_zsse + (size_t)j0 * ks, ks, nt);
  stage_rows(st, kLdT, ka + ks, pr.t_conf + j0, 1, nt);
  for (int i0 = 0; i0 < q2; i0 += kTileQ) {
    const int nq = min(kTileQ, q2 - i0);
    for (int k = warp; k < w; k += kSimWarps)
      if (lane < nq)
        sq[k * kLdQ + lane] = __ldg(qt + (size_t)k * q2 + i0 + lane);
    __syncthreads();
    // rows past the pair leave their warp idle; a tile of at most 32
    // columns computes one column a thread (both uniform in a warp)
    if (warp * kRowsPerThread < nq) {
      if (nt > 32)
        sim_cells<2>(sq, st, tab, ka, ks, alpha, pr.S, q2, t2, i0, j0);
      else
        sim_cells<1>(sq, st, tab, ka, ks, alpha, pr.S, q2, t2, i0, j0);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ K6
//
// One pair of a K6 launch (32 bytes; ops/hmap_device.ZPAIR_DTYPE mirrors
// it): its raw similarity S and its output, each q2 x t2 row-major (out
// may be S), and the first block of the apply pass that covers it.
struct ZPair {
  const float* S;
  float* out;
  int32_t q2, t2, blk0, pad;
};

constexpr int kZWarps = 2;    // pairs (one warp each) per stats block
constexpr int kChunk = 1024;  // region elements per ring slot (4 KB)
constexpr int kStages = 4;    // ring slots: kStages - 1 chunks in flight
constexpr int kApplyPerThread = 16;
constexpr int kApplyElems = kThreads * kApplyPerThread;  // per apply block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 2 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// A lane's place in the serial order of its pair's region [1, q2-1) x
// [1, t2-1) (w = t2 - 2 columns): region row ri, column rj; the lane copies
// every 32nd element.
struct Cursor {
  int ri, rj;
  __device__ __forceinline__ void advance(int w) {
    rj += 32;
    while (rj >= w) {  // once at most unless w < 32
      rj -= w;
      ++ri;
    }
  }
};

// Copy chunk c of the region into slot, one cp.async per element (rows
// start at any 4-byte offset), and commit the group; a chunk past the end
// commits an empty group so that the ring's group count stays uniform.
__device__ __forceinline__ void issue_chunk(float* slot, const float* S,
                                            int t2, int w, int m, int c,
                                            int lane, Cursor& cur) {
  const int e0 = c * kChunk;
#pragma unroll 4
  for (int k = lane; k < kChunk; k += 32) {
    if (e0 + k >= m) break;
    cp_async4(slot + k, S + (cur.ri + 1) * t2 + cur.rj + 1);
    cur.advance(w);
  }
  cp_async_commit();
}

// acc += x.x, .y, .z, .w in order; acc2 likewise over their squares,
// each rounded alone.
__device__ __forceinline__ void add4(float& acc, float& acc2, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc2 = __fadd_rn(acc2, __fmul_rn(x.x, x.x));
  acc = __fadd_rn(acc, x.y);
  acc2 = __fadd_rn(acc2, __fmul_rn(x.y, x.y));
  acc = __fadd_rn(acc, x.z);
  acc2 = __fadd_rn(acc2, __fmul_rn(x.z, x.z));
  acc = __fadd_rn(acc, x.w);
  acc2 = __fadd_rn(acc2, __fmul_rn(x.w, x.w));
}

// stats[p] = (avg, std) of pair p's region, one warp per pair.  The
// chain's order is the contract (hmath.norm_elements_vec), so one lane
// adds every element in row-major region order; the other 31 keep it fed:
// the region streams global -> shared through a ring of kStages chunks
// (cp.async).  Lane 0 walks each chunk four elements at a time (the next
// four loaded before the current ones are added), two independent chains
// (the squares' multiplies fill the adds' latency), while the next chunks'
// copies are in flight.  (A pass in which the warp squares each chunk
// into a second buffer before the walk would lie on the chain's critical
// path; the walk's multiplies fill the adds' latency instead.)
__global__ void __launch_bounds__(32 * kZWarps)
    hmap_znorm_stats_kernel(const ZPair* __restrict__ pairs,
                            float2* __restrict__ stats, int n) {
  __shared__ __align__(16) float ring[kZWarps][kStages][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kZWarps + warp;
  if (p >= n) return;  // the whole warp; no block-wide barrier below
  const ZPair pr = pairs[p];
  const int w = pr.t2 - 2;
  const int m = (pr.q2 - 2) * w;  // the wrapper keeps q2 * t2 below 2^31
  const int chunks = (m + kChunk - 1) / kChunk;
  Cursor cur{lane / w, lane % w};
  for (int c = 0; c < kStages - 1; ++c)
    issue_chunk(ring[warp][c], pr.S, pr.t2, w, m, c, lane, cur);
  float acc = 0.0f;   // +0.0: fl(+0 + x) = x, -0.0 included (+0.0)
  float acc2 = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_ring();
    __syncwarp();
    const float* x = ring[warp][c % kStages];
    const int cnt = min(kChunk, m - c * kChunk);
    // the slot walked in the previous step takes chunk c + kStages - 1
    issue_chunk(ring[warp][(c + kStages - 1) % kStages], pr.S, pr.t2, w, m,
                c + kStages - 1, lane, cur);
    if (lane == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const int n4 = cnt >> 2;
      if (n4 > 0) {
        float4 a = x4[0];
#pragma unroll 4
        for (int k = 1; k < n4; ++k) {
          const float4 next = x4[k];
          add4(acc, acc2, a);
          a = next;
        }
        add4(acc, acc2, a);
      }
      for (int k = n4 << 2; k < cnt; ++k) {
        acc = __fadd_rn(acc, x[k]);
        acc2 = __fadd_rn(acc2, __fmul_rn(x[k], x[k]));
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    const float mf = __int2float_rn(m);
    const float avg = __fdiv_rn(acc, mf);
    const float var = __fsub_rn(__fdiv_rn(acc2, mf), __fmul_rn(avg, avg));
    stats[p] = make_float2(avg, __fsqrt_rn(var));
  }
}

// out = (S - avg) / std + shift inside each pair's region (only + shift
// when not normalizing), 0 on its borders.  One block covers kApplyElems
// consecutive elements of one pair; it finds its pair by a binary search
// over the descriptors' first blocks.
__global__ void __launch_bounds__(kThreads)
    hmap_znorm_apply_kernel(const ZPair* __restrict__ pairs,
                            const float2* __restrict__ stats, int n,
                            float shift, int normalize) {
  const int b = blockIdx.x;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pairs[mid].blk0 <= b) lo = mid;
    else hi = mid - 1;
  }
  const ZPair pr = pairs[lo];
  const int q2 = pr.q2, t2 = pr.t2;
  const int total = q2 * t2;  // the wrapper keeps it below 2^31
  float avg = 0.0f, sd = 1.0f;
  if (normalize) {
    const float2 st = stats[lo];
    avg = st.x;
    sd = st.y;
  }
  int idx = (b - pr.blk0) * kApplyElems + threadIdx.x;
  int i = idx / t2, j = idx % t2;
#pragma unroll 4
  for (int k = 0; k < kApplyPerThread && idx < total; ++k) {
    float v = 0.0f;
    if (i != 0 && i != q2 - 1 && j != 0 && j != t2 - 1) {
      v = pr.S[idx];
      if (normalize) v = __fdiv_rn(__fsub_rn(v, avg), sd);
      v = __fadd_rn(v, shift);
    }
    pr.out[idx] = v;
    idx += kThreads;
    j += kThreads;
    if (j >= t2) {
      i += j / t2;
      j %= t2;
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  Each returns cudaGetLastError() of
// its launches (0 = cudaSuccess).

// K5 over n pairs (SimPair descriptors in device memory, their first
// tiles ascending from 0) and tiles tiles of tile_t columns, which must be
// this file's kTileT, run in passes of tile_q = kTileQ rows (the wrapper's
// descriptors count them so); qt is the query transposed, (ka + ks + 1,
// q2).  cudaErrorInvalidValue when the tiles are not this file's, or when
// the staged rows exceed kSimSmemMax.
extern "C" int hmap_sim_launch(const void* pairs, int n, int tiles,
                               const float* qt, int q2, int ka, int ks,
                               float alpha, int tile_q, int tile_t,
                               void* stream) {
  const size_t smem = sizeof(float) * (size_t)(ka + ks + 1) * (kLdQ + kLdT);
  if (n < 1 || tiles < n || q2 < 3 || ka < 1 || ks < 1 ||
      tile_q != kTileQ || tile_t != kTileT || smem > kSimSmemMax)
    return (int)cudaErrorInvalidValue;
  hmap_sim_kernel<<<tiles, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const SimPair*>(pairs), n, qt, q2, ka, ks, alpha);
  return (int)cudaGetLastError();
}

// K6 over n pairs (ZPair descriptors in device memory, longest region
// first): the stats pass into stats (n float2 scratch) when normalizing,
// then the apply pass over blocks apply blocks (the pairs' blk0 ranges).
extern "C" int hmap_znorm_launch(const void* pairs, float* stats, int n,
                                 int blocks, float shift, int normalize,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ZPair* zp = static_cast<const ZPair*>(pairs);
  float2* st2 = reinterpret_cast<float2*>(stats);
  if (normalize) {
    hmap_znorm_stats_kernel<<<(n + kZWarps - 1) / kZWarps, 32 * kZWarps, 0,
                              st>>>(zp, st2, n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  hmap_znorm_apply_kernel<<<blocks, kThreads, 0, st>>>(zp, st2, n, shift,
                                                       normalize);
  return (int)cudaGetLastError();
}

// Elements of one pair that one apply block covers (the wrapper's blk0).
extern "C" int hmap_znorm_apply_elems(void) { return kApplyElems; }
