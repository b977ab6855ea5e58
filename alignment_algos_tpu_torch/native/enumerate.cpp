// Native enumeration engine: Waterman-family branched tracebacks over a
// device-computed DP matrix (cw / ucw / kscw / crcw semantics, matching the
// Python implementations in core/enumerators byte-for-byte).
//
// The DP scores, traceback and cost tables arrive as flat arrays from the
// TPU engine; enumeration is an output-sensitive recursive host workload,
// which is exactly where native code pays off (the reference's entire
// runtime is C++; this module is its spiritual successor for the
// enumeration stage).  Exposed via a C ABI for ctypes.
//
// Build: tools/build_native.py (c++ -O2 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct CostModel {
    int q2, t2;
    const float* H;        // (q2, t2)
    const int32_t* PQ;     // (q2, t2)
    const int32_t* PT;     // (q2, t2)
    const float* S;        // (q2, t2)
    const float* D;        // (t2, t2) deletion cost (t1 -> t2)
    const float* A;        // (t2,) insertion affine base
    const float* B;        // (t2,) insertion affine slope
    const float* C;        // (t2,) optional constant term (may be null)
    int ins_dist_offset;
    bool ins_zero_head_q;
    bool ins_zero_tail_q;

    inline float h(int i, int j) const { return H[i * t2 + j]; }
    inline int pq(int i, int j) const { return PQ[i * t2 + j]; }
    inline int pt(int i, int j) const { return PT[i * t2 + j]; }
    inline float sim(int i, int j) const { return S[i * t2 + j]; }
    inline float del(int t1, int t2_) const { return D[t1 * t2 + t2_]; }
    inline float ins(int q1, int q2_, int j) const {
        int dist = q2_ - q1;
        if (dist < 2) return 0.0f;
        if (ins_zero_head_q && q1 == 0) return 0.0f;
        if (ins_zero_tail_q && q2_ == q2 - 1) return 0.0f;
        float cost = A[j] + B[j] * (float)(dist - ins_dist_offset);
        if (C) cost = cost + C[j];
        return cost;
    }
};

struct Params {
    int number_suboptimal;
    float delta_ratio;
    unsigned k_limit;
    unsigned sort_limit;
    unsigned user_limit;
    float max_overlap;
};

// an alignment under construction: pairs stored in reverse (appended at the
// back as the traceback prepends), flipped on export
struct Ali {
    std::vector<int32_t> rev_pairs;  // q,t interleaved, reverse order
    float score = 0.0f;
    int uid = -1;
    inline void prepend(int q, int t) {
        rev_pairs.push_back(q);
        rev_pairs.push_back(t);
    }
};

struct Ctx {
    CostModel cm;
    Params p;
    const uint8_t* flags;  // subopt flags, length t2
    std::vector<Ali> as;
    unsigned user_limit;
    bool warn_user;
    float threshold;
};

// ---------------------------------------------------------------- cw / ucw

void cw_branch(Ctx& c, int q0, int t0, int k0, bool force_opt);

void cw_opt_path(Ctx& c, int q0, int t0, int k0, bool force_opt) {
    if (q0 == 1 || t0 == 1) {
        Ali& a = c.as[k0];
        a.prepend(q0, t0);
        a.prepend(0, 0);
        a.score += c.cm.h(q0, t0);
        return;
    }
    Ali& a = c.as[k0];
    int pq = -1, pt = -1;
    bool flag = !c.flags[t0];
    while (t0 > 1 && q0 > 1) {
        if (!force_opt && (bool)c.flags[t0] == flag) break;
        a.prepend(q0, t0);
        a.score += c.cm.sim(q0, t0);
        pq = c.cm.pq(q0, t0);
        pt = c.cm.pt(q0, t0);
        float g = (q0 - pq == 1) ? c.cm.del(pt, t0) : c.cm.ins(pq, q0, t0);
        a.score -= g;
        q0 = pq;
        t0 = pt;
    }
    cw_branch(c, pq, pt, k0, force_opt);
}

void cw_branch(Ctx& c, int q0, int t0, int k0, bool force_opt) {
    if (q0 == 1 || t0 == 1) {
        Ali& a = c.as[k0];
        a.prepend(q0, t0);
        a.prepend(0, 0);
        a.score += c.cm.h(q0, t0);
        return;
    }
    if (force_opt) {
        cw_opt_path(c, q0, t0, k0, true);
        return;
    }
    int k = k0;
    Ali curr = c.as[k0];  // snapshot before extension
    if (c.as.size() > c.user_limit) {
        cw_opt_path(c, q0, t0, k0, true);
        return;
    }
    float r = curr.score + c.cm.sim(q0, t0);
    float f = c.cm.h(q0 - 1, t0 - 1);
    if (f + r > c.threshold) {
        if ((int)c.as.size() == k) c.as.push_back(curr);
        c.as[k].prepend(q0, t0);
        c.as[k].score = r;
        cw_opt_path(c, q0 - 1, t0 - 1, k, force_opt);
        k = (int)c.as.size();
    }
    for (int i = t0 - 2; i > 0; --i) {
        f = c.cm.h(q0 - 1, i);
        float g = c.cm.del(i, t0);
        if (f + r - g > c.threshold) {
            if ((int)c.as.size() == k) c.as.push_back(curr);
            c.as[k].prepend(q0, t0);
            c.as[k].score = r - g;
            cw_opt_path(c, q0 - 1, i, k, force_opt);
            k = (int)c.as.size();
        }
    }
    for (int j = q0 - 2; j > 0; --j) {
        f = c.cm.h(j, t0 - 1);
        float g = c.cm.ins(j, q0, t0);
        if (f + r - g > c.threshold) {
            if ((int)c.as.size() == k) c.as.push_back(curr);
            c.as[k].prepend(q0, t0);
            c.as[k].score = r - g;
            cw_opt_path(c, j, t0 - 1, k, force_opt);
            k = (int)c.as.size();
        }
    }
    if (k == k0) cw_opt_path(c, q0, t0, k0, true);
}

void ucw_opt_path(Ctx& c, int q0, int t0, int k0) {
    Ali& a = c.as[k0];
    while (t0 > 1 && q0 > 1) {
        a.prepend(q0, t0);
        a.score += c.cm.sim(q0, t0);
        int pq = c.cm.pq(q0, t0);
        int pt = c.cm.pt(q0, t0);
        float g = (q0 - pq == 1) ? c.cm.del(pt, t0) : c.cm.ins(pq, q0, t0);
        a.score -= g;
        q0 = pq;
        t0 = pt;
    }
    a.prepend(q0, t0);
    a.prepend(0, 0);
    a.score += c.cm.h(q0, t0);
}

void ucw_branch(Ctx& c, int q0, int t0, int k0) {
    if (q0 == 1 || t0 == 1) {
        Ali& a = c.as[k0];
        a.prepend(q0, t0);
        a.prepend(0, 0);
        a.score += c.cm.h(q0, t0);
        return;
    }
    int k = k0;
    Ali curr = c.as[k0];
    if (c.as.size() > c.user_limit) {
        ucw_opt_path(c, q0, t0, k0);
        return;
    }
    float r = curr.score + c.cm.sim(q0, t0);
    float f = c.cm.h(q0 - 1, t0 - 1);
    if (f + r > c.threshold) {
        if ((int)c.as.size() == k) c.as.push_back(curr);
        c.as[k].prepend(q0, t0);
        c.as[k].score = r;
        ucw_branch(c, q0 - 1, t0 - 1, k);
        k = (int)c.as.size();
    }
    for (int i = t0 - 2; i > 0; --i) {
        f = c.cm.h(q0 - 1, i);
        float g = c.cm.del(i, t0);
        if (f + r - g > c.threshold) {
            if ((int)c.as.size() == k) c.as.push_back(curr);
            c.as[k].prepend(q0, t0);
            c.as[k].score = r - g;
            ucw_branch(c, q0 - 1, i, k);
            k = (int)c.as.size();
        }
    }
    for (int j = q0 - 2; j > 0; --j) {
        f = c.cm.h(j, t0 - 1);
        float g = c.cm.ins(j, q0, t0);
        if (f + r - g > c.threshold) {
            if ((int)c.as.size() == k) c.as.push_back(curr);
            c.as[k].prepend(q0, t0);
            c.as[k].score = r - g;
            ucw_branch(c, j, t0 - 1, k);
            k = (int)c.as.size();
        }
    }
    if (k == k0) ucw_opt_path(c, q0, t0, k0);
}

// ---------------------------------------------------------------- kscw

struct Op {
    unsigned limit;
    unsigned index = 0;
    int q0, t0, k0;
    float score, thresh, new_r;
    inline bool operator<(const Op& o) const { return score > o.score; }
};

void ks_branch(Ctx& c, Op op);

void ks_opt_path(Ctx& c, Op op, bool force_opt) {
    if (op.limit <= 1) force_opt = true;
    int q0 = op.q0, t0 = op.t0, k0 = op.k0;
    if (q0 == 1 || t0 == 1) {
        Ali& a = c.as[k0];
        a.prepend(q0, t0);
        a.prepend(0, 0);
        a.score += c.cm.h(q0, t0);
        return;
    }
    Ali& a = c.as[k0];
    int pq = -1, pt = -1;
    bool flag = !c.flags[t0];
    while (t0 > 1 && q0 > 1) {
        if (!force_opt && (bool)c.flags[t0] == flag) break;
        a.prepend(q0, t0);
        a.score += c.cm.sim(q0, t0);
        pq = c.cm.pq(q0, t0);
        pt = c.cm.pt(q0, t0);
        float g = (q0 - pq == 1) ? c.cm.del(pt, t0) : c.cm.ins(pq, q0, t0);
        a.score -= g;
        q0 = pq;
        t0 = pt;
    }
    Op next = op;
    next.q0 = pq;
    next.t0 = pt;
    ks_branch(c, next);
}

void ks_branch(Ctx& c, Op op) {
    unsigned k_limit = op.limit;
    int q0 = op.q0, t0 = op.t0, k0 = op.k0;
    float threshold = op.thresh;
    if (q0 == 1 || t0 == 1) {
        Ali& a = c.as[k0];
        a.prepend(q0, t0);
        a.prepend(0, 0);
        a.score += c.cm.h(q0, t0);
        return;
    }
    Ali curr = c.as[k0];
    if (c.as.size() > c.p.user_limit) {
        ks_opt_path(c, op, true);
        return;
    }
    std::vector<Op> k_sort;
    float r = curr.score + c.cm.sim(q0, t0);
    float f = c.cm.h(q0 - 1, t0 - 1);
    float sum = f + r;
    if (sum > threshold)
        k_sort.push_back(Op{k_limit / 2, 0, q0 - 1, t0 - 1, k0, sum, threshold, r});
    for (int i = t0 - 2; i > 0; --i) {
        f = c.cm.h(q0 - 1, i);
        float g = c.cm.del(i, t0);
        sum = f + r - g;
        if (sum > threshold)
            k_sort.push_back(Op{k_limit / 2, 0, q0 - 1, i, k0, sum, threshold, r - g});
    }
    for (int j = q0 - 2; j > 0; --j) {
        f = c.cm.h(j, t0 - 1);
        float g = c.cm.ins(j, q0, t0);
        sum = f + r - g;
        if (sum > threshold)
            k_sort.push_back(Op{k_limit / 2, 0, j, t0 - 1, k0, sum, threshold, r - g});
    }
    if (k_sort.empty()) {
        Op forced = op;
        forced.limit = 1;
        ks_opt_path(c, forced, true);
        return;
    }
    if (k_sort.size() > k_limit) {
        std::partial_sort(k_sort.begin(), k_sort.begin() + k_limit, k_sort.end());
        k_sort.erase(k_sort.begin() + k_limit, k_sort.end());
    } else {
        std::sort(k_sort.begin(), k_sort.end());
    }
    k_sort[0].limit *= 2;
    int k = k0;
    for (auto& it : k_sort) {
        it.k0 = k;
        if ((int)c.as.size() == k) {
            c.as.push_back(curr);
            c.as[k].uid = k;
        }
        c.as[k].prepend(q0, t0);
        c.as[k].score = it.new_r;
        ks_opt_path(c, it, false);
        k = (int)c.as.size();
    }
}

// ---------------------------------------------------------------- crcw

struct CrCtx {
    Ctx* base;
    std::vector<int> regions;  // per template index
    unsigned count_redundant = 0, count_subpaths = 0;
};

void cr_branch(CrCtx& cc, Op op);

void cr_force_opt_path(CrCtx& cc, const Op& op) {
    Ctx& c = *cc.base;
    int q0 = op.q0, t0 = op.t0, k0 = op.k0;
    Ali& a = c.as[k0];
    while (t0 > 0 && q0 > 0) {
        a.prepend(q0, t0);
        a.score += c.cm.sim(q0, t0);
        int pq = c.cm.pq(q0, t0);
        int pt = c.cm.pt(q0, t0);
        float g = (q0 - pq == 1) ? c.cm.del(pt, t0) : c.cm.ins(pq, q0, t0);
        a.score -= g;
        q0 = pq;
        t0 = pt;
    }
    a.prepend(0, 0);
}

void cr_filter_and_extend(CrCtx& cc, int q0, int t0, std::vector<Op>& v_op) {
    Ctx& c = *cc.base;
    const int end_alignment = 2;
    size_t n = v_op.size();
    cc.count_subpaths += n;
    std::vector<std::vector<int>> alignments(n, std::vector<int>(t0, -1));
    std::vector<int> p_rq(n), p_rt(n), l_sp(n), state(n);
    std::vector<float> rs(n);

    for (size_t i = 0; i < n; ++i) {
        v_op[i].index = (unsigned)i;
        int q = v_op[i].q0, t = v_op[i].t0;
        l_sp[i] = 1;
        state[i] = cc.regions[t - 1];
        rs[i] = v_op[i].new_r;
        while (q > 0 && t > 0 && cc.regions[t - 1] == state[i]) {
            alignments[i][t - 1] = q;
            ++l_sp[i];
            int pq = c.cm.pq(q, t);
            int pt = c.cm.pt(q, t);
            float g = (q - pq == 1) ? c.cm.del(pt, t) : c.cm.ins(pq, q, t);
            rs[i] += c.cm.sim(q, t);
            rs[i] -= g;
            q = pq;
            t = pt;
        }
        p_rq[i] = q;
        p_rt[i] = t;
        state[i] = cc.regions[t - 1];
    }

    std::vector<bool> filter(n, false);
    filter[0] = true;
    unsigned count = 0, accepted = 1;
    unsigned lim = v_op.back().limit;
    for (size_t i = 1; i < n && accepted < lim; ++i) {
        filter[i] = true;
        for (size_t j = 0; j < i; ++j) {
            if (filter[i] && filter[j] && state[i] == state[j]) {
                float overlap = 0.0f;
                float overlap_max = c.p.max_overlap * (float)l_sp[j];
                if (p_rq[i] == p_rq[j] && p_rt[i] == p_rt[j]) ++overlap;
                for (int k = t0 - 1; k >= p_rt[i]; --k) {
                    if (alignments[i][k] > -1 && alignments[j][k] > -1 &&
                        alignments[i][k] == alignments[j][k]) {
                        ++overlap;
                        if (overlap > overlap_max) {
                            filter[i] = false;
                            ++count;
                            break;
                        }
                    }
                }
            }
        }
        if (filter[i]) ++accepted;
    }
    cc.count_redundant += count;

    std::vector<Op> tmp;
    accepted = 0;
    for (size_t i = 0; i < n && accepted < lim; ++i)
        if (filter[i]) {
            tmp.push_back(v_op[i]);
            ++accepted;
        }
    tmp.swap(v_op);
    for (size_t i = 1; i < v_op.size(); ++i)
        v_op[i].limit = std::max(2u, lim / 2);

    int k = v_op[0].k0;
    Ali curr = c.as[k];
    for (size_t i = 0; i < v_op.size(); ++i) {
        int q0_i = v_op[i].index;
        if (k == (int)c.as.size()) {
            c.as.push_back(curr);
            c.as[k].uid = k;
        }
        c.as[k].prepend(q0, t0);
        for (int j = t0 - 1; j > p_rt[q0_i]; --j) {
            int ali_q0 = alignments[q0_i][j - 1];
            if (ali_q0 > -1) c.as[k].prepend(ali_q0, j);
        }
        c.as[k].score = rs[q0_i];
        v_op[i].q0 = p_rq[q0_i];
        v_op[i].t0 = p_rt[q0_i];
        v_op[i].k0 = k;
        if (p_rq[q0_i] <= end_alignment || p_rt[q0_i] <= end_alignment) {
            cr_force_opt_path(cc, v_op[i]);
            v_op[i].k0 = -1;
        }
        k = (int)c.as.size();
    }
}

void cr_branch(CrCtx& cc, Op op) {
    Ctx& c = *cc.base;
    unsigned k_limit = op.limit;
    int q0 = op.q0, t0 = op.t0, k0 = op.k0;
    if (k_limit < 2) {
        cr_force_opt_path(cc, op);
        return;
    }
    if (c.as.size() > c.p.user_limit) {
        cr_force_opt_path(cc, op);
        return;
    }
    std::vector<Op> all_op;
    float r = c.as[k0].score + c.cm.sim(q0, t0);
    float f = c.cm.h(q0 - 1, t0 - 1);
    float sum = f + r;
    if (sum > c.threshold)
        all_op.push_back(Op{k_limit, 0, q0 - 1, t0 - 1, k0, sum, 0, r});
    for (int i = t0 - 2; i > 0; --i) {
        f = c.cm.h(q0 - 1, i);
        float g = c.cm.del(i, t0);
        sum = f + r - g;
        if (sum > c.threshold)
            all_op.push_back(Op{k_limit, 0, q0 - 1, i, k0, sum, 0, r - g});
    }
    for (int j = q0 - 2; j > 0; --j) {
        f = c.cm.h(j, t0 - 1);
        float g = c.cm.ins(j, q0, t0);
        sum = f + r - g;
        if (sum > c.threshold)
            all_op.push_back(Op{k_limit, 0, j, t0 - 1, k0, sum, 0, r - g});
    }
    if (all_op.empty()) {
        cr_force_opt_path(cc, op);
        return;
    }
    if (all_op.size() > c.p.sort_limit) {
        std::partial_sort(all_op.begin(), all_op.begin() + c.p.sort_limit,
                          all_op.end());
        all_op.erase(all_op.begin() + c.p.sort_limit, all_op.end());
    } else {
        std::sort(all_op.begin(), all_op.end());
    }
    cr_filter_and_extend(cc, q0, t0, all_op);
    for (auto& it : all_op)
        if (it.k0 > -1) cr_branch(cc, it);
}

// ------------------------------------------------------------ entry points

struct Result {
    int32_t n_alis;
    int32_t* pair_counts;   // per alignment
    float* scores;
    int32_t* uids;
    int32_t* pairs;         // concatenated (q, t) pairs, forward order
    uint32_t count_redundant, count_subpaths;
};

Result* package(Ctx& c, unsigned cr_red = 0, unsigned cr_sub = 0) {
    // sortSet: std::sort / partial_sort by score desc + truncate.
    // number_suboptimal < 0 skips sorting (the caller merges with an
    // existing alignment set and sorts the whole set itself).
    struct Less {
        bool operator()(const Ali& a, const Ali& b) const {
            return a.score > b.score;
        }
    };
    int max_n = c.p.number_suboptimal;
    if (max_n >= (int)c.as.size()) {
        std::sort(c.as.begin(), c.as.end(), Less());
    } else if (max_n > 0) {
        std::partial_sort(c.as.begin(), c.as.begin() + max_n, c.as.end(), Less());
        c.as.erase(c.as.begin() + max_n, c.as.end());
    }  // max_n < 0: leave in DFS emission order

    Result* r = new Result();
    r->n_alis = (int32_t)c.as.size();
    r->pair_counts = (int32_t*)malloc(sizeof(int32_t) * c.as.size());
    r->scores = (float*)malloc(sizeof(float) * c.as.size());
    r->uids = (int32_t*)malloc(sizeof(int32_t) * c.as.size());
    size_t total = 0;
    for (auto& a : c.as) total += a.rev_pairs.size() / 2;
    r->pairs = (int32_t*)malloc(sizeof(int32_t) * total * 2);
    size_t off = 0;
    for (size_t i = 0; i < c.as.size(); ++i) {
        const Ali& a = c.as[i];
        size_t np = a.rev_pairs.size() / 2;
        r->pair_counts[i] = (int32_t)np;
        r->scores[i] = a.score;
        r->uids[i] = a.uid;
        // reverse the reversed pair list into forward order
        for (size_t p = 0; p < np; ++p) {
            r->pairs[off + 2 * p] = a.rev_pairs[2 * (np - 1 - p)];
            r->pairs[off + 2 * p + 1] = a.rev_pairs[2 * (np - 1 - p) + 1];
        }
        off += 2 * np;
    }
    r->count_redundant = cr_red;
    r->count_subpaths = cr_sub;
    return r;
}

}  // namespace

extern "C" {

Result* enumerate_tracebacks(
    int mode,  // 0=cw 1=ucw 2=kscw 3=crcw
    int q2, int t2,
    const float* H, const int32_t* PQ, const int32_t* PT,
    const float* S, const float* D,
    const float* A, const float* B, const float* C, int has_C,
    int ins_dist_offset, int ins_zero_head, int ins_zero_tail,
    const uint8_t* flags,
    int number_suboptimal, float delta_ratio, unsigned k_limit,
    unsigned sort_limit, unsigned user_limit, float max_overlap) {

    Ctx c;
    c.cm = CostModel{q2, t2, H, PQ, PT, S, D, A, B,
                     has_C ? C : nullptr, ins_dist_offset,
                     ins_zero_head != 0, ins_zero_tail != 0};
    c.p = Params{number_suboptimal, delta_ratio, k_limit, sort_limit,
                 user_limit, max_overlap};
    c.flags = flags;
    c.warn_user = true;

    int q_last = q2 - 1;
    int t_last = t2 - 1;
    float opt = c.cm.h(q_last, t_last);
    c.threshold = (1.0f - delta_ratio) * opt;
    c.threshold = std::min(c.threshold, opt - 0.1f);

    unsigned cr_red = 0, cr_sub = 0;

    switch (mode) {
        case 0: {  // cw: hardcoded user limit (cw.h:76)
            c.user_limit = 1000000;
            Ali a;
            a.uid = 0;
            c.as.push_back(a);
            cw_branch(c, q_last, t_last, (int)c.as.size() - 1, false);
            break;
        }
        case 1: {  // ucw: hardcoded user limit (ucw.h:73)
            c.user_limit = 100000;
            c.as.push_back(Ali());
            ucw_branch(c, q_last, t_last, (int)c.as.size() - 1);
            break;
        }
        case 2: {  // kscw
            c.user_limit = user_limit;
            Ali a;
            a.uid = 1;
            c.as.push_back(a);
            ks_branch(c, Op{k_limit, 0, q_last, t_last,
                            (int)c.as.size() - 1, 0, c.threshold, 0});
            break;
        }
        case 3: {  // crcw
            c.user_limit = user_limit;
            CrCtx cc;
            cc.base = &c;
            cc.regions.resize(t_last, 0);
            int state = 0;
            for (int i = 0; i + 1 < t2; ++i) {
                if (flags[i + 1] != flags[i]) ++state;
                cc.regions[i] = state;
            }
            Ali a;
            a.uid = 1;
            c.as.push_back(a);
            cr_branch(cc, Op{k_limit, 0, q_last, t_last,
                             (int)c.as.size() - 1, 0, 0, 0});
            cr_red = cc.count_redundant;
            cr_sub = cc.count_subpaths;
            break;
        }
        default:
            return nullptr;
    }
    return package(c, cr_red, cr_sub);
}

void free_result(Result* r) {
    if (!r) return;
    free(r->pair_counts);
    free(r->scores);
    free(r->uids);
    free(r->pairs);
    delete r;
}

}  // extern "C"
