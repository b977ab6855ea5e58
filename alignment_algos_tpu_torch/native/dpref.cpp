// Native exact general-gap DP builder.
//
// Function-by-function translation of ops/dp_ref.py (itself the byte-
// parity-validated reimplementation of dpmatrix.h:356-1030): match first,
// then deletion candidates (ascending k forward / descending reverse), then
// insertion candidates, strict-improvement tie-breaking, float32 in the
// reference's op order (s = H[pred] - gap + sim).  Compile with
// -ffp-contract=off.
//
// This is the host engine for small rectangles — most importantly the SSSS
// per-skeleton loop fills, where the Python per-cell numpy loop costs tens
// of milliseconds per fill.

#include <cstdint>

namespace {

struct Cost {
  const float* S;   // (q2, t2)
  const float* D;   // (t2, t2)
  const float* A;   // (t2,)
  const float* B;   // (t2,)
  const float* C;   // (t2,) or null
  long ins_off;     // ins_dist_offset
  int zero_head;    // ins_zero_head_q
  int zero_tail;    // ins_zero_tail_q
  long q2, t2;

  float s(long i, long j) const { return S[i * t2 + j]; }
  float d(long k, long j) const { return D[k * t2 + j]; }

  // DPCosts.ins_cost_of_dist for one span at column j (no head/tail rules)
  float ins_cost_raw(long dist, long j) const {
    if (dist < 2) return 0.0f;
    float cost = A[j] + B[j] * (float)(dist - ins_off);
    if (C) cost = cost + C[j];
    return cost;
  }

  // dp_ref._ins_cost_vec element: gap from row k to destination row qpos
  float ins_cost_vec(long k, long qpos, long j) const {
    if (zero_tail && qpos == q2 - 1) return 0.0f;
    if (zero_head && k == 0) return 0.0f;
    return ins_cost_raw(qpos - k, j);
  }

  // DPCosts.insertion scalar (boundary column / forced steps)
  float ins_scalar(long k1, long k2, long j) const {
    long dist = k2 - k1;
    if (dist < 2) return 0.0f;
    if (zero_head && k1 == 0) return 0.0f;
    if (zero_tail && k2 == q2 - 1) return 0.0f;
    return ins_cost_raw(dist, j);
  }
};

struct Out {
  float* H;
  int32_t* PQ;
  int32_t* PT;
  long t2;
  void set(long i, long j, long pq, long pt, float s) {
    H[i * t2 + j] = s;
    PQ[i * t2 + j] = (int32_t)pq;
    PT[i * t2 + j] = (int32_t)pt;
  }
  float h(long i, long j) const { return H[i * t2 + j]; }
};

inline float clampf(float x, int local) {
  return (local && x < 0.0f) ? 0.0f : x;
}

}  // namespace

extern "C" {

long dpref_build_forward(const float* S, const float* D, const float* A,
                         const float* B, const float* C, long ins_off,
                         int zero_head, int zero_tail, long q2, long t2,
                         long q0, long q1, long t0, long t1, int local,
                         float* H, int32_t* PQ, int32_t* PT) {
  Cost c{S, D, A, B, C, ins_off, zero_head, zero_tail, q2, t2};
  Out o{H, PQ, PT, t2};
  if (q1 <= q0 || t1 <= t0) return -1;
  float s_init = o.h(q0, t0);

  if (q1 == q0 + 1) {  // forced deletion step (dpmatrix.h:375-382)
    float s = (s_init - c.d(t0, t1)) + c.s(q1, t1);
    o.set(q1, t1, q0, t0, s);
    return 0;
  }
  if (t1 == t0 + 1) {  // forced insertion step
    float s = (s_init - c.ins_scalar(q0, q1, t1)) + c.s(q1, t1);
    o.set(q1, t1, q0, t0, s);
    return 0;
  }

  // boundary cells
  o.set(q0 + 1, t0 + 1, q0, t0, clampf(s_init + c.s(q0 + 1, t0 + 1), local));
  for (long j = t0 + 2; j < t1; j++) {
    float s = (s_init - c.d(t0, j)) + c.s(q0 + 1, j);
    o.set(q0 + 1, j, q0, t0, clampf(s, local));
  }
  for (long i = q0 + 2; i < q1; i++) {
    float s = (s_init - c.ins_scalar(q0, i, t0 + 1)) + c.s(i, t0 + 1);
    o.set(i, t0 + 1, q0, t0, clampf(s, local));
  }

  // interior cells
  for (long i = q0 + 2; i < q1; i++) {
    for (long j = t0 + 2; j < t1; j++) {
      float sim = c.s(i, j);
      long opt_i = i - 1, opt_j = j - 1;
      float opt_s = clampf(o.h(i - 1, j - 1) + sim, local);

      // deletion candidates k in [t0+1, j-2], first strict max wins
      {
        float m = 0.0f;
        long am = -1;
        for (long k = t0 + 1; k <= j - 2; k++) {
          float cv = clampf((o.h(i - 1, k) - c.d(k, j)) + sim, local);
          if (am < 0 || cv > m) {
            m = cv;
            am = k;
          }
        }
        if (am >= 0 && m > opt_s) {
          opt_s = m;
          opt_i = i - 1;
          opt_j = am;
        }
      }
      // insertion candidates k in [q0+1, i-2]
      {
        float m = 0.0f;
        long am = -1;
        for (long k = q0 + 1; k <= i - 2; k++) {
          float cv = clampf((o.h(k, j - 1) - c.ins_cost_vec(k, i, j)) + sim,
                            local);
          if (am < 0 || cv > m) {
            m = cv;
            am = k;
          }
        }
        if (am >= 0 && m > opt_s) {
          opt_s = m;
          opt_i = am;
          opt_j = j - 1;
        }
      }
      o.set(i, j, opt_i, opt_j, opt_s);
    }
  }

  // closing cell (q1, t1) (dpmatrix.h:504-534)
  {
    float sim = c.s(q1, t1);
    long opt_i = q1 - 1, opt_j = t1 - 1;
    float opt_s = clampf(o.h(q1 - 1, t1 - 1) + sim, local);
    {
      float m = 0.0f;
      long am = -1;
      for (long k = t0 + 1; k <= t1 - 1; k++) {
        float cv = clampf((o.h(q1 - 1, k) - c.d(k, t1)) + sim, local);
        if (am < 0 || cv > m) {
          m = cv;
          am = k;
        }
      }
      if (am >= 0 && m > opt_s) {
        opt_s = m;
        opt_i = q1 - 1;
        opt_j = am;
      }
    }
    {
      float m = 0.0f;
      long am = -1;
      for (long k = q0 + 1; k <= q1 - 1; k++) {
        float cv = clampf((o.h(k, t1 - 1) - c.ins_cost_vec(k, q1, t1)) + sim,
                          local);
        if (am < 0 || cv > m) {
          m = cv;
          am = k;
        }
      }
      if (am >= 0 && m > opt_s) {
        opt_s = m;
        opt_i = am;
        opt_j = t1 - 1;
      }
    }
    o.set(q1, t1, opt_i, opt_j, opt_s);
  }
  return 0;
}

long dpref_build_reverse(const float* S, const float* D, const float* A,
                         const float* B, const float* C, long ins_off,
                         int zero_head, int zero_tail, long q2, long t2,
                         long q0, long q1, long t0, long t1, int local,
                         int bug_compat, float* H, int32_t* PQ, int32_t* PT) {
  Cost c{S, D, A, B, C, ins_off, zero_head, zero_tail, q2, t2};
  Out o{H, PQ, PT, t2};
  if (q1 <= q0 || t1 <= t0) return -1;
  float s_init = o.h(q1, t1);

  if (q1 == q0 + 1) {
    float s = (s_init - c.d(t0, t1)) + c.s(q0, t0);
    o.set(q0, t0, q1, t1, s);
    return 0;
  }
  if (t1 == t0 + 1) {
    float s = (s_init - c.ins_scalar(q0, q1, t1)) + c.s(q0, t0);
    o.set(q0, t0, q1, t1, s);
    return 0;
  }

  o.set(q1 - 1, t1 - 1, q1, t1, clampf(s_init + c.s(q1 - 1, t1 - 1), local));
  for (long j = t1 - 2; j > t0; j--) {
    float s = (s_init - c.d(j, t1)) + c.s(q1 - 1, j);
    o.set(q1 - 1, j, q1, t1, clampf(s, local));
  }
  for (long i = q1 - 2; i > q0; i--) {
    float s = (s_init - c.ins_scalar(i, q1, t1)) + c.s(i, t1 - 1);
    o.set(i, t1 - 1, q1, t1, clampf(s, local));
  }

  for (long i = q1 - 2; i > q0; i--) {
    for (long j = t1 - 2; j > t0; j--) {
      float sim = c.s(i, j);
      long opt_i = i + 1, opt_j = j + 1;
      float opt_s = clampf(o.h(i + 1, j + 1) + sim, local);

      // deletion candidates k descending in [j+2, t1-1]
      {
        float m = 0.0f;
        long am = -1;
        for (long k = t1 - 1; k >= j + 2; k--) {
          float cv = clampf((o.h(i + 1, k) - c.d(j, k)) + sim, local);
          if (am < 0 || cv > m) {
            m = cv;
            am = k;
          }
        }
        if (am >= 0 && m > opt_s) {
          opt_s = m;
          opt_i = i + 1;
          opt_j = am;
        }
      }
      // insertion candidates k descending in [i+2, q1-1]; cost of span
      // (i..k) at column j+1 with dp_ref's reverse head/tail rules
      {
        float m = 0.0f;
        long am = -1;
        for (long k = q1 - 1; k >= i + 2; k--) {
          float cost;
          if (zero_head && i == 0) {
            cost = 0.0f;
          } else if (zero_tail && k == q2 - 1) {
            cost = 0.0f;
          } else {
            cost = c.ins_cost_raw(k - i, j + 1);
          }
          float cv = clampf((o.h(k, j + 1) - cost) + sim, local);
          if (am < 0 || cv > m) {
            m = cv;
            am = k;
          }
        }
        if (am >= 0 && m > opt_s) {
          opt_s = m;
          opt_i = am;
          opt_j = j + 1;
        }
      }
      o.set(i, j, opt_i, opt_j, opt_s);
    }
  }

  // closing cell (q0, t0) (dpmatrix.h:844-874)
  {
    float sim = c.s(q0, t0);
    long opt_i = q0 + 1, opt_j = t0 + 1;
    float opt_s = clampf(o.h(q0 + 1, t0 + 1) + sim, local);
    {
      float m = 0.0f;
      long am = -1;
      for (long k = t1 - 1; k >= t0 + 1; k--) {
        float cv = clampf((o.h(q0 + 1, k) - c.d(t0, k)) + sim, local);
        if (am < 0 || cv > m) {
          m = cv;
          am = k;
        }
      }
      if (am >= 0 && m > opt_s) {
        opt_s = m;
        opt_i = q0 + 1;
        opt_j = am;
      }
    }
    {
      float m = 0.0f;
      long am = -1;
      for (long k = q1 - 1; k >= q0 + 1; k--) {
        float cost;
        if (zero_head && q0 == 0) {
          cost = 0.0f;
        } else if (zero_tail && k == q2 - 1) {
          cost = 0.0f;
        } else {
          cost = c.ins_cost_raw(k - q0, t0 + 1);
        }
        float cv = clampf((o.h(k, t0 + 1) - cost) + sim, local);
        if (am < 0 || cv > m) {
          m = cv;
          am = k;
        }
      }
      if (am >= 0 && m > opt_s) {
        opt_s = m;
        opt_i = am;
        // dpmatrix.h:868 records t1-1 instead of t0+1 (non-local only)
        opt_j = (local || !bug_compat) ? (t0 + 1) : (t1 - 1);
      }
    }
    o.set(q0, t0, opt_i, opt_j, opt_s);
  }
  return 0;
}

}  // extern "C"
