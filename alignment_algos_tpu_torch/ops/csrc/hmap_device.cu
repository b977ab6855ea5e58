// Device HMAP similarity producer for Hopper (sm_90a): two kernels.
//
//   K5 hmap_sim_kernel replaces alignment_algos_tpu/ops/hmap_device.py
//      build_similarity_device (:137) up to the z-norm: the raw
//      similarity ip * expf(((alpha * pc) * conf_q) * conf_t) with
//      nan_to_num and zeroed borders.
//   K6 hmap_znorm_kernel replaces _znorm_scalars (:172) and the rest of
//      build_similarity_device: the mean and standard deviation of the
//      [1, q2-1) x [1, t2-1) region as a strictly serial float32 chain in
//      row-major order, then (S - avg) / std + zero_shift inside the
//      region (only + zero_shift when not normalizing), 0 on the borders.
//      One host call launches its two passes (stats, apply).
// Neither is a Pallas kernel on the TPU (XLA code with binary64 emulated on
// uint32 pairs); on the card the arithmetic is native.
//
// Exactness (bit-equal to HMAPaliEval.build_costs' S, the host path):
//   * every dot product is a serial multiply-then-add chain in k, as
//     utils/hmath.seq_matmul_f32; the build passes -fmad=false, so no
//     multiply and add are contracted anywhere in this file;
//   * pc = dot3 / 3 and the z-norm's divisions are IEEE float32 division,
//     the square root sqrtf, both correctly rounded under nvcc's defaults
//     (-prec-div=true, -prec-sqrt=true), so sf64's integer-corrected div32
//     and sqrt32 have no counterpart;
//   * expf is a replica of glibc 2.36 __expf_fma (the libm the host path
//     calls) in native float64 with __fma_rn at exactly the sites where that
//     build fuses (ops/sf64.py expf_bits, :444-457), on finite |x| < 87;
//     beyond, +inf (x > 0) or +0, and NaN passes through (the domain rule of
//     hmap_device._expf_ieee, the reference's documented 87-88 deviation);
//   * the z-norm sums are one serial chain per pair: torch.sum and
//     torch.cumsum accumulate in another order and round differently.
//
// What bounds them.  K5: one thread per cell, 23 multiply-adds and one
// expf, about 100 bytes of profile reads per cell from L1: arithmetic and
// latency, far below a roofline.  K6's stats pass: one thread per pair
// walks about 65,000 dependent adds at 258 x 258, so it is latency bound by
// design (the order is the contract); its apply pass is elementwise.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit, on a 5-pair
// 258 x 258 bucket: K5 0.062 ms, K6 1.43 ms (almost all of it the chain).

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
// r = z - k; s = 2^(k/32); y = s * (C0 r^3 + C1 r^2 + C2 r + 1).
__device__ __forceinline__ float expf_replica(float x) {
  const double xd = (double)x;
  const double zs = __fma_rn(kInvLn2N, xd, kShift);
  const uint64_t ki = (uint64_t)__double_as_longlong(zs);
  const double kd = __dsub_rn(zs, kShift);
  const double r = __fma_rn(kInvLn2N, xd, -kd);
  const uint64_t t = kTab[ki % 32] + (ki << 47);
  const double s = __longlong_as_double((long long)t);
  const double z2 = __fma_rn(kC0, r, kC1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(kC2, r, 1.0);
  y = __fma_rn(z2, r2, y);
  y = __dmul_rn(y, s);
  return __double2float_rn(y);
}

__device__ __forceinline__ float expf_domain(float x) {
  if (x != x) return x;
  if (fabsf(x) < 87.0f) return expf_replica(x);
  return x > 0.0f ? __int_as_float(0x7f800000) : 0.0f;
}

// q_aa (q2, ka), q_zsse (q2, ks), q_conf (q2,); t_aa (n, t2, ka),
// t_zsse (n, t2, ks), t_conf (n, t2); S (n, q2, t2).
__global__ void hmap_sim_kernel(const float* __restrict__ q_aa,
                                const float* __restrict__ q_zsse,
                                const float* __restrict__ q_conf,
                                const float* __restrict__ t_aa,
                                const float* __restrict__ t_zsse,
                                const float* __restrict__ t_conf, float alpha,
                                float* __restrict__ S, int n, int q2, int t2,
                                int ka, int ks) {
  const size_t total = (size_t)n * q2 * t2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t qt = (size_t)q2 * t2;
  const size_t p = idx / qt;
  const int i = (int)((idx % qt) / t2);
  const int j = (int)(idx % t2);
  if (i == 0 || i == q2 - 1 || j == 0 || j == t2 - 1) {
    S[idx] = 0.0f;
    return;
  }
  const size_t tj = p * t2 + j;
  const float* qa = q_aa + (size_t)i * ka;
  const float* ta = t_aa + tj * ka;
  float ip = qa[0] * ta[0];
  for (int k = 1; k < ka; ++k) ip = ip + qa[k] * ta[k];
  const float* qz = q_zsse + (size_t)i * ks;
  const float* tz = t_zsse + tj * ks;
  float dot = qz[0] * tz[0];
  for (int k = 1; k < ks; ++k) dot = dot + qz[k] * tz[k];
  const float pc = dot / (float)ks;
  float arg = alpha * pc;
  arg = arg * q_conf[i];
  arg = arg * t_conf[tj];
  const float v = ip * expf_domain(arg);
  S[idx] = fabsf(v) <= kFltMax ? v : 0.0f;  // nan_to_num: NaN, +-inf -> 0
}

// stats (n, 2): the region's mean and standard deviation, one thread per
// pair, one serial chain each.
__global__ void hmap_znorm_stats_kernel(const float* __restrict__ S,
                                        float* __restrict__ stats, int n,
                                        int q2, int t2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* s = S + (size_t)p * q2 * t2;
  float acc = 0.0f;
  float acc2 = 0.0f;
  for (int i = 1; i < q2 - 1; ++i) {
    const float* row = s + (size_t)i * t2;
    for (int j = 1; j < t2 - 1; ++j) {
      const float x = row[j];
      acc = acc + x;
      acc2 = acc2 + x * x;
    }
  }
  const float m = (float)((q2 - 2) * (t2 - 2));
  const float avg = acc / m;
  const float var = acc2 / m - avg * avg;
  stats[2 * p] = avg;
  stats[2 * p + 1] = sqrtf(var);
}

__global__ void hmap_znorm_apply_kernel(const float* __restrict__ S,
                                        float* __restrict__ out,
                                        const float* __restrict__ stats,
                                        float shift, int n, int q2, int t2,
                                        int normalize) {
  const size_t total = (size_t)n * q2 * t2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t qt = (size_t)q2 * t2;
  const size_t p = idx / qt;
  const int i = (int)((idx % qt) / t2);
  const int j = (int)(idx % t2);
  if (i == 0 || i == q2 - 1 || j == 0 || j == t2 - 1) {
    out[idx] = 0.0f;
    return;
  }
  float v = S[idx];
  if (normalize) v = (v - stats[2 * p]) / stats[2 * p + 1];
  out[idx] = v + shift;
}

unsigned grid_of(size_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Every pointer is a device
// pointer; stream is a cudaStream_t.  Each returns cudaGetLastError() of
// its launches (0 = cudaSuccess).

extern "C" int hmap_sim_launch(const float* q_aa, const float* q_zsse,
                               const float* q_conf, const float* t_aa,
                               const float* t_zsse, const float* t_conf,
                               float alpha, float* S, int n, int q2, int t2,
                               int ka, int ks, void* stream) {
  const size_t total = (size_t)n * q2 * t2;
  hmap_sim_kernel<<<grid_of(total), kThreads, 0, (cudaStream_t)stream>>>(
      q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf, alpha, S, n, q2, t2, ka,
      ks);
  return (int)cudaGetLastError();
}

// stats: (n, 2) scratch; out may not alias S.
extern "C" int hmap_znorm_launch(const float* S, float* out, float* stats,
                                 float shift, int n, int q2, int t2,
                                 int normalize, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (normalize) {
    hmap_znorm_stats_kernel<<<(n + 31) / 32, 32, 0, st>>>(S, stats, n, q2,
                                                          t2);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const size_t total = (size_t)n * q2 * t2;
  hmap_znorm_apply_kernel<<<grid_of(total), kThreads, 0, st>>>(
      S, out, stats, shift, n, q2, t2, normalize);
  return (int)cudaGetLastError();
}
