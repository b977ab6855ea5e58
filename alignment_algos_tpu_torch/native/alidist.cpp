// Native all-pairs alignment-distance engine.
//
// Replicates analysis/ali_dist.py's area computation (itself byte-exact vs
// the reference's Ali_Dist, ali_dist.cpp:160-414) bit-for-bit in float32:
// classify vertices against the other polyline, insert pairwise segment
// intersections and matching-abscissa points into both polylines, then sum
// signed trapezoid differences.  Compile with -ffp-contract=off so every
// float op rounds exactly like the numpy float32 expression tree.
//
// This is the analysis-layer hot loop: K alignments -> K(K-1)/2 polyline
// comparisons for UPGMA/k-medoid clustering and skeleton deduplication.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct RP {
  float t;
  float q;
  int rel;
};

// _relative_position (ali_dist.py:109-128): +1 above / -1 below / 0 on.
// Returns -9 on "point outside alignment range".
int rel_pos(float t, float q, const RP* pts, long n) {
  long nxt = 1;
  while (nxt < n && pts[nxt].t < t) nxt++;
  if (nxt >= n) return -9;
  const RP& p = pts[nxt - 1];
  const RP& nx = pts[nxt];
  if (t == nx.t) {
    if (q == nx.q) return 0;
    return q > nx.q ? 1 : -1;
  }
  float m = (nx.q - p.q) / (nx.t - p.t);
  float b = p.q - m * p.t;
  float shadow = m * t + b;
  if (q == shadow) return 0;
  return q > shadow ? 1 : -1;
}

// _advance: move whichever next pointer trails (both if tied).
inline void advance(const std::vector<RP>& a1, const std::vector<RP>& a2,
                    long& i1, long& i2) {
  if (a1[i1].t < a2[i2].t) {
    i1++;
  } else if (a1[i1].t > a2[i2].t) {
    i2++;
  } else {
    i1++;
    i2++;
  }
}

// _insert_intersections (ali_dist.py:137-159)
void insert_intersections(std::vector<RP>& a1, std::vector<RP>& a2) {
  long i1 = 1, i2 = 1;
  while (i1 < (long)a1.size() && i2 < (long)a2.size()) {
    const RP p1 = a1[i1 - 1], n1 = a1[i1];
    const RP p2 = a2[i2 - 1], n2 = a2[i2];
    if (p1.rel * n1.rel == -1 || p2.rel * n2.rel == -1) {
      float m1 = (n1.q - p1.q) / (n1.t - p1.t);
      float m2 = (n2.q - p2.q) / (n2.t - p2.t);
      if (m1 == m2) {
        advance(a1, a2, i1, i2);
        continue;
      }
      float num = (p1.q - p2.q) - (m1 * p1.t - m2 * p2.t);
      float xp = num / (m2 - m1);
      float yp = p1.q + m1 * (xp - p1.t);
      if (!(p1.t < xp && xp < n1.t && p2.t < xp && xp < n2.t)) {
        advance(a1, a2, i1, i2);
        continue;
      }
      a1.insert(a1.begin() + i1, RP{xp, yp, 0});
      a2.insert(a2.begin() + i2, RP{xp, yp, 0});
      // next pointers now reference the inserted point (no advance)
    } else {
      advance(a1, a2, i1, i2);
    }
  }
}

// _insert_matching_points (ali_dist.py:161-181)
void insert_matching_points(std::vector<RP>& a1, std::vector<RP>& a2) {
  long i1 = 1, i2 = 1;
  while (i1 < (long)a1.size() && i2 < (long)a2.size()) {
    const RP n1 = a1[i1], n2 = a2[i2];
    if (n1.t != n2.t) {
      if (n1.t < n2.t) {  // add point to a2
        const RP p2 = a2[i2 - 1];
        float m = (n2.q - p2.q) / (n2.t - p2.t);
        float b = p2.q - m * p2.t;
        float shadow = m * n1.t + b;
        a2.insert(a2.begin() + i2, RP{n1.t, shadow, -1 * n1.rel});
      } else {
        const RP p1 = a1[i1 - 1];
        float m = (n1.q - p1.q) / (n1.t - p1.t);
        float b = p1.q - m * p1.t;
        float shadow = m * n2.t + b;
        a1.insert(a1.begin() + i1, RP{n2.t, shadow, -1 * n2.rel});
      }
    } else {
      i1++;
      i2++;
    }
  }
}

// _area_between (ali_dist.py:183-200); sequential float32 accumulation.
int area_between(const std::vector<RP>& a1, const std::vector<RP>& a2,
                 float* out) {
  if (a1.size() != a2.size()) return -2;
  float total = 0.0f;
  for (long i = 1; i < (long)a2.size(); i++) {
    if (a1[i - 1].rel == 0 && a1[i].rel == 0) continue;
    float area1 = ((a1[i].q + a1[i - 1].q) / 2.0f) * (a1[i].t - a1[i - 1].t);
    float area2 = ((a2[i].q + a2[i - 1].q) / 2.0f) * (a2[i].t - a2[i - 1].t);
    if (a1[i - 1].rel > 0 || a1[i].rel > 0) {
      total = total + (area1 - area2);
    } else {
      total = total + (area2 - area1);
    }
  }
  *out = total;
  return 0;
}

// get_area_between_main_and_test (ali_dist.py:221-229) for one pair.
int area_pair(const float* at, const float* aq, long an, const float* bt,
              const float* bq, long bn, float* out) {
  std::vector<RP> main_tmp(an), test(bn);
  for (long i = 0; i < an; i++) main_tmp[i] = RP{at[i], aq[i], -2};
  for (long i = 0; i < bn; i++) test[i] = RP{bt[i], bq[i], -2};
  for (long i = 0; i < an; i++) {
    int r = rel_pos(main_tmp[i].t, main_tmp[i].q, test.data(), bn);
    if (r == -9) return -1;
    main_tmp[i].rel = r;
  }
  for (long i = 0; i < bn; i++) {
    int r = rel_pos(test[i].t, test[i].q, main_tmp.data(), an);
    if (r == -9) return -1;
    test[i].rel = r;
  }
  insert_intersections(main_tmp, test);
  insert_matching_points(main_tmp, test);
  return area_between(main_tmp, test, out);
}

}  // namespace

extern "C" {

// Full symmetric K x K area matrix over polylines given as concatenated
// (ts, qs) arrays with offs[k+1] prefix offsets.  Returns 0, or a negative
// code on the first failing pair (caller falls back to the host path).
long ali_area_matrix(const float* ts, const float* qs, const int64_t* offs,
                     long k, float* out) {
  for (long i = 0; i < k; i++) out[i * k + i] = 0.0f;
  for (long i = 0; i < k; i++) {
    for (long j = 0; j < i; j++) {
      float a;
      int rc = area_pair(ts + offs[i], qs + offs[i], offs[i + 1] - offs[i],
                         ts + offs[j], qs + offs[j], offs[j + 1] - offs[j],
                         &a);
      if (rc != 0) return rc;
      out[i * k + j] = a;
      out[j * k + i] = a;
    }
  }
  return 0;
}

// Areas of one main polyline vs k test polylines (get_shifts batch shape).
long ali_area_one_to_many(const float* mt, const float* mq, long mn,
                          const float* ts, const float* qs,
                          const int64_t* offs, long k, float* out) {
  for (long j = 0; j < k; j++) {
    int rc = area_pair(mt, mq, mn, ts + offs[j], qs + offs[j],
                       offs[j + 1] - offs[j], &out[j]);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
