// Native SSSS phase-2 engine: skeleton DFS + constrained-regrowth
// duplicate suppression + coverage/contact-order/strand filters, with
// optional tracking mode (every culled skeleton measured against the
// native alignment — skel_set.cpp:501-531 — via the alidist area engine,
// kept in four shift-ranked lists capped at 100).
//
// Exact translation of ssss/skel_set.py + skel_ali.py (themselves byte-
// parity-validated against the reference's Skel_Set/Skel_Ali,
// skel_set.cpp:110-477 / skel_ali.cpp:92-198).  Float32 score
// accumulation replicates the Python/NumPy op order (compile with
// -ffp-contract=off).  The Python engine remains the fallback.
//
// The fragment graph is passed as flat arrays: frags (geometry + score +
// flags) and a global connection table with per-frag [start,end) ranges.
// Results are returned as global-connection-id sequences per kept skeleton,
// ranked exactly like the Python insertion sort.

#include <cstdint>
#include <cstring>
#include <vector>

// from alidist.cpp (compiled into the same shared object)
extern "C" long ali_area_one_to_many(const float* mt, const float* mq,
                                     long mn, const float* ts,
                                     const float* qs, const int64_t* offs,
                                     long k, float* out);

namespace {

struct Graph {
  const int32_t* f_sse;
  const int32_t* f_fid;
  const int32_t* f_ct0;   // core_t0
  const int32_t* f_ct1;   // core_t1
  const int32_t* f_qt;    // qt_shift
  const float* f_score;
  const uint8_t* f_cterm;
  const int64_t* conn_off;  // per-frag [start,end) into connection table
  const int32_t* c_prev;    // frag index
  const int32_t* c_next;    // frag index
  const int32_t* c_pend;    // prev_end_res_idx
  const int32_t* c_nbeg;    // next_beg_res_idx
  const float* c_score;
  const uint8_t* contacts;  // templ_len x templ_len row-major bool
  const int32_t* tsr_to_c;
  long templ_len;
  long min_aligned;
  double min_sse_co;
  long max_alis;
  // strand rules: All_Strands_Paired rows (first element is the strand,
  // rest its partners) and No_Missing_Cores triples
  const int32_t* asp_data;
  const int64_t* asp_off;
  long n_asp;
  const int32_t* nmc_data;  // 3 * n_nmc
  long n_nmc;
  int bug_compat;
  // tracking mode (skel_set.py _handle_culled_skel_ali)
  int tracking;
  const float* main_t;      // native-alignment polyline
  const float* main_q;
  long main_len;
  float main_templ_len;     // measurer.templ_length (shift denominator)
};

struct Skel {
  std::vector<int32_t> conns;     // global connection ids
  std::vector<int8_t> cr;         // contacting_residues
  float score = 0.0f;
  int num_aligned = 0;
  int num_contacting = 0;
  float sse_co = 0.0f;

  int last_frag(const Graph& g) const { return g.c_next[conns.back()]; }
};

struct Cull {
  float shift;
  float sse_co;                   // value at cull time (0 if never calc'd)
  std::vector<int32_t> conns;
};

struct Search {
  const Graph& g;
  std::vector<Skel> top;          // ranked, capped at max_alis
  const Skel* orig = nullptr;     // constrained-regrowth target
  Skel best_constrained;
  bool have_constrained = false;
  bool error = false;
  std::vector<Cull> culls[4];     // by reason-1; shift-ascending, cap 100
  long num_culled[4] = {0, 0, 0, 0};

  explicit Search(const Graph& gg) : g(gg) {}

  // ---- SkelAli state updates (skel_ali.py) --------------------------
  void init_skel(Skel& s, int32_t cid) const {
    s.conns.clear();
    s.conns.push_back(cid);
    int pf = g.c_prev[cid], nf = g.c_next[cid];
    float sc = g.f_score[pf];
    sc = sc + g.c_score[cid];
    sc = sc + g.f_score[nf];
    s.score = sc;
    s.num_aligned = g.f_ct1[nf] - g.c_nbeg[cid] + 1;
    s.num_contacting = 0;
    s.cr.assign(g.templ_len, -1);
    for (int t = g.c_nbeg[cid]; t <= g.f_ct1[nf]; t++) s.cr[t] = 0;
  }

  void mark_contacts(Skel& s, int t_from, int t_to, int t_step,
                     long fc_hi) const {
    // iterate t_new over [t_from..t_to) by t_step (exclusive end),
    // matching Python range() semantics
    for (int t_new = t_from;
         (t_step > 0) ? (t_new < t_to) : (t_new > t_to); t_new += t_step) {
      for (long fc_idx = 1; fc_idx < fc_hi; fc_idx++) {
        int beg = g.c_nbeg[s.conns[fc_idx - 1]];
        int end = g.c_pend[s.conns[fc_idx]];
        for (int t_prev = beg; t_prev <= end; t_prev++) {
          if (g.contacts[(long)t_new * g.templ_len + t_prev]) {
            if (s.cr[t_new] == 0) {
              s.num_contacting++;
              s.cr[t_new] = 1;
            }
            if (s.cr[t_prev] == 0) {
              s.num_contacting++;
              s.cr[t_prev] = 1;
            }
          }
        }
      }
    }
  }

  void add_connection(Skel& s, int32_t cid) const {
    s.conns.push_back(cid);
    int pf = g.c_prev[cid], nf = g.c_next[cid];
    float sc = s.score;
    sc = sc + g.f_score[nf];
    sc = sc + g.c_score[cid];
    s.score = sc;

    int prev_core_t1 = g.f_ct1[pf];
    if (!g.f_cterm[nf]) {
      s.num_aligned += (g.c_pend[cid] - prev_core_t1)
                       + (g.f_ct1[nf] - g.c_nbeg[cid] + 1);
    } else {
      s.num_aligned += g.c_pend[cid] - prev_core_t1;
    }
    for (int i = g.c_pend[cid]; i > prev_core_t1; i--) s.cr[i] = 0;
    for (int i = g.c_nbeg[cid]; i <= g.f_ct1[nf]; i++) s.cr[i] = 0;
    // _update_contacted_residues
    long n = (long)s.conns.size();
    mark_contacts(s, g.c_pend[cid], prev_core_t1, -1, n - 1);
    mark_contacts(s, g.c_nbeg[cid], g.f_ct1[nf] + 1, 1, n);
  }

  // ---- filters -------------------------------------------------------
  bool strand_rules_pass(const Skel& s) const {
    // sse_id list = next frag of every connection except the last
    std::vector<char> in(4096, 0);
    int maxid = 0;
    for (size_t i = 0; i + 1 < s.conns.size(); i++) {
      int sid = g.f_sse[g.c_next[s.conns[i]]];
      if (sid >= (int)in.size()) in.resize(sid + 1, 0);
      in[sid] = 1;
      if (sid > maxid) maxid = sid;
    }
    auto has = [&](int sid) { return sid <= maxid && sid >= 0 && in[sid]; };
    for (long r = 0; r < g.n_asp; r++) {
      const int32_t* row = g.asp_data + g.asp_off[r];
      long len = g.asp_off[r + 1] - g.asp_off[r];
      if (has(row[0])) {
        bool any = false;
        for (long j = 1; j < len; j++) {
          if (has(row[j])) { any = true; break; }
        }
        if (!any) return false;
      }
    }
    for (long r = 0; r < g.n_nmc; r++) {
      int s1 = g.nmc_data[3 * r], s2 = g.nmc_data[3 * r + 1],
          core = g.nmc_data[3 * r + 2];
      if (has(s1) && has(s2) && !has(core)) return false;
    }
    return true;
  }

  // returns 0 on pass, else the cull reason (1 coverage, 2 SSE_CO,
  // 3 strand rules)
  int filter_reason(Skel& s) const {
    if (s.num_aligned < g.min_aligned) return 1;
    if ((double)s.sse_co < g.min_sse_co) return 2;
    bool passes = strand_rules_pass(s);
    if (g.bug_compat) {
      if (passes) return 3;  // skel_set.cpp:442 sense inversion
    } else {
      if (!passes) return 3;
    }
    return 0;
  }

  // ---- tracking (skel_set.py _handle_culled_skel_ali) -----------------
  void handle_culled(const Skel& s, int reason) {
    // export_vrp: two points per connection, q = t + qt_shift
    size_t n = s.conns.size() * 2;
    std::vector<float> ts(n), qs(n);
    for (size_t i = 0; i < s.conns.size(); i++) {
      int32_t cid = s.conns[i];
      int pf = g.c_prev[cid], nf = g.c_next[cid];
      ts[2 * i] = (float)g.c_pend[cid];
      qs[2 * i] = (float)(g.c_pend[cid] + g.f_qt[pf]);
      ts[2 * i + 1] = (float)g.c_nbeg[cid];
      qs[2 * i + 1] = (float)(g.c_nbeg[cid] + g.f_qt[nf]);
    }
    int64_t offs[2] = {0, (int64_t)n};
    float area = 0.0f;
    if (ali_area_one_to_many(g.main_t, g.main_q, g.main_len, ts.data(),
                             qs.data(), offs, 1, &area) != 0) {
      error = true;
      return;
    }
    float shift = area / g.main_templ_len;
    std::vector<Cull>& lst = culls[reason - 1];
    size_t pos = lst.size();
    while (pos > 0 && lst[pos - 1].shift > shift) pos--;
    lst.insert(lst.begin() + pos, Cull{shift, s.sse_co, s.conns});
    if (lst.size() > 100) lst.pop_back();  // max_bad_alis
    num_culled[reason - 1]++;
  }

  void calc_sse_co(Skel& s) const {
    s.sse_co = (float)s.num_contacting / (float)s.num_aligned;
  }

  // ---- main DFS (skel_set.py _grow_skel) -----------------------------
  void grow(Skel& s) {
    if (error) return;
    int last = s.last_frag(g);
    if (s.num_aligned + g.tsr_to_c[g.f_ct1[last]] < g.min_aligned) {
      // _pre_empt_low_coverage
      if (g.tracking && s.num_aligned > 0.75 * (double)g.min_aligned) {
        if (!g.f_cterm[last]) {
          // cap off with the frag's last connection (the C-cap)
          add_connection(s, (int32_t)(g.conn_off[last + 1] - 1));
        }
        handle_culled(s, 1);
      }
      return;
    }
    if (g.f_cterm[last]) {
      handle_completed(s);
      return;
    }
    for (int64_t c = g.conn_off[last]; c < g.conn_off[last + 1]; c++) {
      Skel child = s;
      add_connection(child, (int32_t)c);
      grow(child);
    }
  }

  void handle_completed(Skel& s) {
    calc_sse_co(s);
    int reason = filter_reason(s);
    if (reason != 0) {
      if (g.tracking) handle_culled(s, reason);
      return;
    }
    find_top_constrained(s);
    if (error) return;
    // keep only if s IS the best constrained completion of itself
    if (!same_skeleton(best_constrained, s)) return;
    insert_ranked(s);
  }

  static bool same_skeleton(const Skel& a, const Skel& b) {
    if (a.conns.size() != b.conns.size()) return false;
    return a.conns == b.conns;  // same connection ids => same frag sequence
  }

  void insert_ranked(const Skel& s) {
    size_t pos = top.size();
    while (pos > 0 && top[pos - 1].score < s.score) pos--;
    top.insert(top.begin() + pos, s);
    if ((long)top.size() > g.max_alis) {
      if (g.tracking) handle_culled(top.back(), 4);
      top.pop_back();
    }
  }

  // ---- constrained regrowth (skel_set.py:118-179) ---------------------
  void find_top_constrained(const Skel& orig_s) {
    orig = &orig_s;
    have_constrained = false;
    int orig_first = g.c_next[orig_s.conns[0]];
    int ncap = g.c_prev[orig_s.conns[0]];
    for (int64_t c = g.conn_off[ncap]; c < g.conn_off[ncap + 1]; c++) {
      int nf = g.c_next[c];
      if (g.f_sse[nf] < g.f_sse[orig_first]
          || (g.f_sse[nf] == g.f_sse[orig_first]
              && g.f_fid[nf] == g.f_fid[orig_first])) {
        Skel sa;
        init_skel(sa, (int32_t)c);
        grow_constrained(sa, 1);
      }
    }
    if (!have_constrained) error = true;  // mirrors the Python RuntimeError
  }

  static bool frags_in_order(const Graph& g, int a, int b) {
    // frag_set.py frags_in_order(af1, af2)
    int a_q1 = g.f_ct1[a] + g.f_qt[a];
    int b_q0 = g.f_ct0[b] + g.f_qt[b];
    return (g.f_ct1[a] + 1 < g.f_ct0[b]) && (a_q1 + 1 < b_q0);
  }

  void grow_constrained(Skel& sa, size_t post_idx) {
    if (error) return;
    int last = sa.last_frag(g);
    if (g.f_cterm[last]) {
      handle_completed_constrained(sa);
      return;
    }
    int post = g.c_next[orig->conns[post_idx]];
    for (int64_t c = g.conn_off[last]; c < g.conn_off[last + 1]; c++) {
      int nf = g.c_next[c];
      if (g.f_sse[nf] > g.f_sse[post]) break;
      if (g.f_sse[nf] == g.f_sse[post] && g.f_fid[nf] > g.f_fid[post]) break;
      if (g.f_sse[nf] == g.f_sse[post] && g.f_fid[nf] < g.f_fid[post])
        continue;
      bool is_post = (g.f_sse[nf] == g.f_sse[post]
                      && g.f_fid[nf] == g.f_fid[post]);
      if (!is_post && !frags_in_order(g, nf, post)) continue;
      Skel child = sa;
      add_connection(child, (int32_t)c);
      // _find_next_post
      int curr_last = child.last_frag(g);
      size_t next_post = post_idx;
      if (g.f_sse[curr_last] == g.f_sse[post]) {
        if (g.f_fid[curr_last] == g.f_fid[post]) {
          next_post = post_idx + 1;
        } else {
          error = true;
          return;
        }
      } else if (g.f_sse[curr_last] > g.f_sse[post]) {
        error = true;
        return;
      }
      grow_constrained(child, next_post);
    }
  }

  void handle_completed_constrained(Skel& sa) {
    calc_sse_co(sa);
    if (filter_reason(sa) != 0) return;
    if (!have_constrained || sa.score > best_constrained.score) {
      best_constrained = sa;
      have_constrained = true;
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of kept skeletons (<= max_alis), or -1 on internal
// inconsistency (caller falls back to the Python engine).  Outputs:
//   out_conns: concatenated connection-id sequences
//   out_lens:  per-skeleton sequence length (max_alis entries)
// Caller provides out_conns sized max_alis * max_conns_per_skel.
//
// Tracking mode (tracking != 0): main_t/main_q/main_len is the native
// alignment polyline, main_templ_len the shift denominator.  Culled
// skeletons come back in the out_cull_* buffers (4 reasons x up to 100
// entries, shift-ascending): conns (4*100*max_conns_per_skel), lens /
// shifts / sse_cos (4*100), counts (4, kept-list sizes) and totals
// (4, all culls measured).
long ssss_find_top_skels(
    const int32_t* f_sse, const int32_t* f_fid, const int32_t* f_ct0,
    const int32_t* f_ct1, const int32_t* f_qt, const float* f_score,
    const uint8_t* f_cterm, long nf, const int64_t* conn_off,
    const int32_t* c_prev, const int32_t* c_next, const int32_t* c_pend,
    const int32_t* c_nbeg, const float* c_score, long nc, long ncap,
    const uint8_t* contacts, long templ_len, const int32_t* tsr_to_c,
    long min_aligned, double min_sse_co, long max_alis,
    const int32_t* asp_data, const int64_t* asp_off, long n_asp,
    const int32_t* nmc_data, long n_nmc, int bug_compat,
    int tracking, const float* main_t, const float* main_q, long main_len,
    double main_templ_len,
    int32_t* out_conns, int32_t* out_lens, long max_conns_per_skel,
    int32_t* out_cull_conns, int32_t* out_cull_lens, float* out_cull_shifts,
    float* out_cull_cos, int64_t* out_cull_counts, int64_t* out_cull_totals) {
  Graph g{f_sse, f_fid, f_ct0, f_ct1, f_qt, f_score, f_cterm, conn_off,
          c_prev, c_next, c_pend, c_nbeg, c_score, contacts, tsr_to_c,
          templ_len, min_aligned, min_sse_co, max_alis,
          asp_data, asp_off, n_asp, nmc_data, n_nmc, bug_compat,
          tracking, main_t, main_q, main_len, (float)main_templ_len};
  (void)nf;
  (void)nc;
  Search srch(g);
  // Start_Skels: one per N-cap connection, in order
  for (int64_t c = g.conn_off[ncap]; c < g.conn_off[ncap + 1]; c++) {
    Skel sa;
    srch.init_skel(sa, (int32_t)c);
    srch.grow(sa);
    if (srch.error) return -1;
  }
  long n = (long)srch.top.size();
  for (long i = 0; i < n; i++) {
    const Skel& s = srch.top[i];
    if ((long)s.conns.size() > max_conns_per_skel) return -1;
    out_lens[i] = (int32_t)s.conns.size();
    std::memcpy(out_conns + i * max_conns_per_skel, s.conns.data(),
                s.conns.size() * sizeof(int32_t));
  }
  if (tracking) {
    for (int r = 0; r < 4; r++) {
      const std::vector<Cull>& lst = srch.culls[r];
      out_cull_counts[r] = (int64_t)lst.size();
      out_cull_totals[r] = srch.num_culled[r];
      for (size_t i = 0; i < lst.size(); i++) {
        long row = r * 100 + (long)i;
        if ((long)lst[i].conns.size() > max_conns_per_skel) return -1;
        out_cull_lens[row] = (int32_t)lst[i].conns.size();
        out_cull_shifts[row] = lst[i].shift;
        out_cull_cos[row] = lst[i].sse_co;
        std::memcpy(out_cull_conns + row * max_conns_per_skel,
                    lst[i].conns.data(),
                    lst[i].conns.size() * sizeof(int32_t));
      }
    }
  }
  return n;
}

}  // extern "C"
