// Native host-side kernels for hairsplitter_tpu_torch (a copy of the JAX
// package's native/hs_native.cpp, built by ops/_build.py:build_native).
//
// The reference implements its host runtime in C++/OpenMP (stage binaries,
// src/*.cpp); here the device work lives in XLA/Pallas and this small C++
// library accelerates the remaining host-side inner loops that don't
// vectorize well in numpy:
//   - longest monotonic anchor subsequence (chaining, seeding.py),
//   - kNN read-graph construction (separate_reads.py / create_read_graph,
//     reference src/separate_reads.cpp:445-530),
//   - Chinese Whispers label propagation (reference
//     src/cluster_graph.cpp:152-310) with a deterministic seeded RNG.
//
// Exposed with a plain C ABI for ctypes; built by native/Makefile.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Longest subsequence strictly increasing in both q and t (patience LIS on q;
// anchors must be pre-sorted by t). Returns the subsequence length; indices
// written to out (caller allocates n entries).
int64_t hs_lis_monotonic(const int64_t* q, int64_t n, int64_t* out) {
    if (n == 0) return 0;
    std::vector<int64_t> tails;       // q values of pile tops
    std::vector<int64_t> tails_idx;   // their indices
    std::vector<int64_t> parent(n, -1);
    tails.reserve(n);
    tails_idx.reserve(n);
    for (int64_t i = 0; i < n; i++) {
        auto it = std::lower_bound(tails.begin(), tails.end(), q[i]);
        int64_t j = it - tails.begin();
        if (j > 0) parent[i] = tails_idx[j - 1];
        if (it == tails.end()) {
            tails.push_back(q[i]);
            tails_idx.push_back(i);
        } else if (q[i] < *it) {
            *it = q[i];
            tails_idx[j] = i;
        }
    }
    int64_t len = 0;
    int64_t cur = tails_idx.back();
    std::vector<int64_t> rev;
    rev.reserve(tails.size());
    while (cur >= 0) {
        rev.push_back(cur);
        cur = parent[cur];
    }
    for (auto it2 = rev.rbegin(); it2 != rev.rend(); ++it2) out[len++] = *it2;
    return len;
}

// ---------------------------------------------------------------------------
// Read-graph construction: distance/knee thresholds of the reference
// (src/separate_reads.cpp:462-515). sim/diff are n*n int32, mask n uint8,
// adj out n*n int8 (0/1).
void hs_create_read_graph(const int32_t* sim, const int32_t* diff,
                          const uint8_t* mask, int64_t n, float error_rate,
                          int8_t* adj) {
    std::memset(adj, 0, (size_t)n * n);
    std::vector<std::pair<float, int64_t>> order;
    std::vector<float> dist(n);
    float d_floor = std::min(1.0f - 2.0f * error_rate, 0.99f);
    for (int64_t r1 = 0; r1 < n; r1++) {
        if (!mask[r1]) continue;
        const int32_t* s = sim + r1 * n;
        const int32_t* d = diff + r1 * n;
        float max_compat = 5.0f;
        for (int64_t r = 0; r < n; r++) {
            dist[r] = 0.0f;
            if (mask[r] && r != r1 && s[r] > 0) {
                float dd = std::max(0, d[r] - 1);
                dist[r] = 1.0f - dd / float(s[r] + d[r]);
                if (s[r] > max_compat) max_compat = (float)s[r];
            }
        }
        // 0.7*max capped at an absolute column mass (MIN_OVERLAP_CAP,
        // see pipeline/separate_reads.py — keep the three twins in sync)
        float floor_compat = std::max(5.0f, std::min(0.7f * max_compat, 18.0f));
        for (int64_t r = 0; r < n; r++) {
            if (mask[r] && r != r1 && (float)(s[r] + d[r]) < floor_compat) dist[r] = 0.0f;
        }
        order.clear();
        for (int64_t r = 0; r < n; r++) order.push_back({dist[r], r});
        std::stable_sort(order.begin(), order.end(),
                         [](const auto& a, const auto& b) { return a.first > b.first; });
        float link_thr = 1.0f;
        if (n > 1) link_thr = order[0].first - (order[0].first - order[1].first) * 3.0f;
        if (link_thr == 1.0f) {
            int64_t k = 0;
            while (k < n && order[k].first == 1.0f) k++;
            if (k < n) {
                int64_t k2 = std::min(k + 4, n - 1);
                link_thr = order[k2].first;
            }
        }
        int nb = 0;
        for (auto& pr : order) {
            float dj = pr.first;
            int64_t jx = pr.second;
            if (dj > d_floor && (nb < 5 || dj == 1.0f || dj >= link_thr) && mask[jx]) {
                nb++;
                adj[r1 * n + jx] = 1;
                adj[jx * n + r1] = 1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// splitmix64 for deterministic shuffles / tie-breaks
static inline uint64_t mix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// Chinese Whispers: async label propagation with seeded random order and
// random tie-breaks (reference src/cluster_graph.cpp:240-310; stop when a
// sweep changes < 3 labels, max n_iters sweeps). adj n*n int8, labels int64
// in/out, mask uint8.
void hs_chinese_whispers(const int8_t* adj, int64_t n, int64_t* labels,
                         const uint8_t* mask, int32_t n_iters, uint64_t seed) {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; i++) order[i] = i;
    for (int64_t i = 0; i < n; i++)
        if (!mask[i]) labels[i] = -2;
    std::vector<int64_t> counts(n + 1, 0);
    uint64_t state = seed ^ 0xD1B54A32D192ED03ull;
    for (int32_t it = 0; it < n_iters; it++) {
        int changes = 0;
        // Fisher-Yates with splitmix64
        for (int64_t i = n - 1; i > 0; i--) {
            state = mix64(state);
            int64_t j = (int64_t)(state % (uint64_t)(i + 1));
            std::swap(order[i], order[j]);
        }
        for (int64_t oi = 0; oi < n; oi++) {
            int64_t i = order[oi];
            if (!mask[i]) continue;
            const int8_t* row = adj + i * n;
            int64_t maxv = 0;
            for (int64_t r = 0; r < n; r++) {
                if (row[r] && labels[r] >= 0) {
                    int64_t c = ++counts[labels[r]];
                    if (c > maxv) maxv = c;
                }
            }
            if (maxv > 0) {
                // random tie-break among distinct argmax labels (reservoir)
                int64_t n_ties = 0, best = -1;
                for (int64_t r = 0; r < n; r++) {
                    int64_t lab = labels[r];
                    if (row[r] && lab >= 0 && counts[lab] == maxv) {
                        counts[lab] = 0;  // visit each label once + reset
                        n_ties++;
                        state = mix64(state);
                        if ((int64_t)(state % (uint64_t)n_ties) == 0) best = lab;
                    } else if (row[r] && lab >= 0) {
                        counts[lab] = 0;
                    }
                }
                if (best >= 0 && labels[i] != best) {
                    labels[i] = best;
                    changes++;
                }
            } else {
                for (int64_t r = 0; r < n; r++)
                    if (row[r] && labels[r] >= 0) counts[labels[r]] = 0;
            }
        }
        if (changes < 3) break;
    }
}

// ---------------------------------------------------------------------------
// merge_close_clusters (separate_reads.py twin; reference
// cluster_graph.cpp:402-501): per cluster, let its nodes defect to the
// weighted-majority neighboring cluster over up to 10 sweeps; keep the
// result only if the cluster dissolves entirely. Bit-identical to the numpy
// version: ascending node order, first-argmax tie-breaks (smallest label),
// sequential label updates within a sweep.
void hs_merge_close_clusters(const int8_t* adj, int64_t n, int64_t* labels,
                             const uint8_t* mask) {
    std::vector<int64_t> clusters;
    for (int64_t i = 0; i < n; i++)
        if (labels[i] >= 0) clusters.push_back(labels[i]);
    std::sort(clusters.begin(), clusters.end());
    clusters.erase(std::unique(clusters.begin(), clusters.end()), clusters.end());
    std::vector<int64_t> cur(labels, labels + n), trial(n);
    std::vector<int64_t> counts(n + 2, 0);
    for (int64_t ci = 0; ci < (int64_t)clusters.size(); ci++) {
        int64_t cluster = clusters[ci];
        std::copy(cur.begin(), cur.end(), trial.begin());
        for (int sweep = 0; sweep < 10; sweep++) {
            int64_t changes = 0;
            for (int64_t i = 0; i < n; i++) {
                if (!mask[i] || trial[i] != cluster) continue;
                const int8_t* row = adj + i * n;
                int64_t maxlab = -1;
                for (int64_t r = 0; r < n; r++) {
                    if (row[r] && trial[r] >= 0) {
                        counts[trial[r]] += row[r];
                        if (trial[r] > maxlab) maxlab = trial[r];
                    }
                }
                if (maxlab < 0) continue;
                // first argmax over label values 0..maxlab (numpy argmax)
                int64_t best = 0, bv = counts[0];
                for (int64_t l = 1; l <= maxlab; l++)
                    if (counts[l] > bv) { bv = counts[l]; best = l; }
                // second: first argmax with counts[best] treated as -1
                int64_t second = -1, sv = -2;
                for (int64_t l = 0; l <= maxlab; l++) {
                    int64_t v = (l == best) ? -1 : counts[l];
                    if (v > sv) { sv = v; second = l; }
                }
                if (bv > 0 && best != cluster) {
                    trial[i] = best;
                    changes++;
                } else if (bv > 0 && second >= 0 && bv <= 2 * sv) {
                    trial[i] = second;
                    changes++;
                }
                for (int64_t l = 0; l <= maxlab; l++) counts[l] = 0;
            }
            if (changes == 0) break;
        }
        bool gone = true;
        for (int64_t i = 0; i < n; i++)
            if (trial[i] == cluster) { gone = false; break; }
        if (gone) std::copy(trial.begin(), trial.end(), cur.begin());
    }
    std::copy(cur.begin(), cur.end(), labels);
}

// ---------------------------------------------------------------------------
// Fused banded DP + readout + traceback for the CPU backend — the scalar
// twin of ops/align.py (banded_align_batch + readout + traceback_batch),
// bit-identical by construction (same formulas, same first-argmin
// tie-breaks, same masked INF semantics). XLA-CPU runs the jnp scan at
// ~50 Mcells/s; this loop runs at ~0.5-1 Gcells/s and threads across jobs,
// so CPU-backend mapping (tests, non-TPU deployments) stops being DP-bound.
static const int32_t HS_ALIGN_INF = 1 << 20;
static const int8_t HS_T_SENTINEL = 6;
enum { HS_TB_EQ = 0, HS_TB_X = 1, HS_TB_I = 2, HS_TB_D = 3 };

static void hs_align_one(const int8_t* q, int32_t qlen, const int8_t* t,
                         int32_t tlen, int32_t mode, int32_t B, int32_t T,
                         int32_t W, uint8_t* bp /* [B*W] scratch */,
                         int32_t* prev, int32_t* row, int32_t* row_at_q,
                         int8_t* ops_out, int32_t* n_ops_out,
                         int64_t* cost_out, int64_t* clip_out) {
    const int32_t dl = W / 2;
    auto tp = [&](int32_t x) -> int8_t {  // t padded with dl left sentinels
        int32_t j = x - dl;
        return (j < 0 || j >= T) ? HS_T_SENTINEL : t[j];
    };
    // row 0: leading deletions
    for (int32_t b = 0; b < W; b++) {
        int32_t j0 = b - dl;
        prev[b] = (j0 >= 0 && j0 <= tlen) ? j0 : HS_ALIGN_INF;
    }
    bool have_rowq = (qlen == 0);
    if (have_rowq) std::copy(prev, prev + W, row_at_q);
    else std::fill(row_at_q, row_at_q + W, HS_ALIGN_INF);
    int32_t colmin_val = HS_ALIGN_INF, colmin_i = 0;

    for (int32_t i = 1; i <= B; i++) {
        const int8_t qc = q[i - 1];
        // diag/up + exact prefix-min in x-space (x = D - b)
        int32_t running = HS_ALIGN_INF;  // min over b' <= b of tmp[b'] - b'
        const bool row_valid_i = (i <= qlen);
        uint8_t* bprow = bp + (size_t)(i - 1) * W;
        for (int32_t b = 0; b < W; b++) {
            int32_t sub = (qc == tp(i - 1 + b)) ? 0 : 1;
            int32_t diag = prev[b] + sub;
            int32_t up = ((b < W - 1) ? prev[b + 1] : HS_ALIGN_INF) + 1;
            int32_t tmp = diag < up ? diag : up;
            int32_t x = tmp - b;
            if (x < running) running = x;
            int32_t r = running + b;
            int32_t j = i + b - dl;
            int32_t rv;
            if (j >= 0 && j <= tlen && row_valid_i)
                rv = r < HS_ALIGN_INF ? r : HS_ALIGN_INF;
            else
                rv = HS_ALIGN_INF;
            row[b] = rv;
            bprow[b] = (rv == diag) ? 0 : (rv == up) ? 1 : 2;
        }
        if (i == qlen) { std::copy(row, row + W, row_at_q); have_rowq = true; }
        int32_t b_col = tlen - i + dl;
        if (b_col >= 0 && b_col < W && i <= qlen) {
            int32_t colv = row[b_col];
            if (colv < colmin_val) { colmin_val = colv; colmin_i = i; }
        }
        std::swap(prev, row);
    }

    // readout (ops/align.py:readout, same first-argmin tie-breaks)
    int32_t b_corner = tlen - qlen + dl;
    int64_t corner = (b_corner >= 0 && b_corner < W) ? row_at_q[b_corner] : HS_ALIGN_INF;
    int32_t b_row = 0;
    int64_t rowbest = HS_ALIGN_INF + (int64_t)0;
    {
        int32_t best = HS_ALIGN_INF;
        int32_t bi = 0;
        for (int32_t b = 0; b < W; b++) {
            int32_t j = qlen + b - dl;
            int32_t v = (j >= 0 && j <= tlen) ? row_at_q[b] : HS_ALIGN_INF;
            if (v < best) { best = v; bi = b; }
        }
        b_row = bi;
        rowbest = best;
    }
    bool is_ext = (mode == 1);
    bool use_col = is_ext && (colmin_val < rowbest);
    int64_t cost = is_ext ? (rowbest < colmin_val ? rowbest : colmin_val) : corner;
    int64_t start_i = use_col ? colmin_i : qlen;
    int64_t start_b = use_col ? (tlen - colmin_i + dl) : (is_ext ? b_row : b_corner);
    int64_t clip = use_col ? (qlen - colmin_i) : 0;
    if (cost >= HS_ALIGN_INF) { start_i = 0; start_b = dl; clip = 0; }
    *cost_out = cost;
    *clip_out = clip;

    // traceback (ops/align.py:traceback_batch, scalar walk, then reverse)
    int64_t i64 = start_i, b64 = start_b;
    int32_t n = 0;
    const int64_t max_steps = (int64_t)B + (B + (W - 1 - W / 2)) + 1;  // B + t_width + 1
    for (int64_t s = 0; s < max_steps; s++) {
        int64_t jcol = i64 + b64 - dl;
        if (!(i64 > 0 || jcol > 0)) break;
        int8_t op;
        if (i64 == 0) {
            op = HS_TB_D;
            b64 -= 1;
        } else {
            int64_t bi = i64 - 1;
            if (bi < 0) bi = 0;
            if (bi > B - 1) bi = B - 1;
            int64_t bc = b64 < 0 ? 0 : (b64 > W - 1 ? W - 1 : b64);
            uint8_t bpv = bp[(size_t)bi * W + bc];
            int64_t qi = i64 - 1;
            if (qi < 0) qi = 0;
            if (qi > B - 1) qi = B - 1;
            int64_t tj = jcol - 1;
            if (tj < 0) tj = 0;
            if (tj > T - 1) tj = T - 1;
            if (bpv == 0) {
                op = (q[qi] == t[tj]) ? HS_TB_EQ : HS_TB_X;
                i64 -= 1;
            } else if (bpv == 1) {
                op = HS_TB_I;
                i64 -= 1;
                b64 += 1;
            } else {
                op = HS_TB_D;
                b64 -= 1;
            }
        }
        ops_out[n++] = op;
    }
    std::reverse(ops_out, ops_out + n);
    *n_ops_out = n;
}

// jobs laid out as padded arrays exactly like the jnp path; ops written to
// per-job regions of stride (B + t_width + 1) with lengths in n_ops.
void hs_banded_align_tb(const int8_t* q, const int32_t* qlens, const int8_t* t,
                        const int32_t* tlens, const int32_t* modes, int64_t n,
                        int32_t B, int32_t T, int32_t W, int8_t* ops,
                        int64_t ops_stride, int32_t* n_ops, int64_t* cost,
                        int64_t* clip, int32_t n_threads) {
    if (n <= 0) return;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = (int32_t)n;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<uint8_t> bp((size_t)B * W);
        std::vector<int32_t> prev(W), row(W), rowq(W);
        while (true) {
            int64_t k = next.fetch_add(1);
            if (k >= n) break;
            hs_align_one(q + k * B, qlens[k], t + k * T, tlens[k], modes[k], B,
                         T, W, bp.data(), prev.data(), row.data(), rowq.data(),
                         ops + k * ops_stride, n_ops + k, cost + k, clip + k);
        }
    };
    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int32_t tnum = 0; tnum < n_threads; tnum++) threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }
}

// ---------------------------------------------------------------------------
// Minimizer extraction (seeding.py:minimizers, bit-identical): rolling 2-bit
// fwd/rc k-mers, splitmix64 canonical hash, leftmost window minimum via a
// monotonic deque, adjacent-duplicate emission collapse (== np.unique of
// per-window argmins), bad-base (code>3) and palindromic k-mers masked out.
static inline uint64_t hs_mix64(uint64_t x) {
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

int64_t hs_minimizers(const int8_t* codes, int64_t n, int32_t k, int32_t w,
                      int64_t* out_pos, uint64_t* out_hash, int8_t* out_strand) {
    if (n < k) return 0;
    const int64_t m = n - k + 1;
    const uint64_t MAXU = ~0ULL;
    std::vector<uint64_t> h(m);
    std::vector<int8_t> str(m);
    uint64_t fwd = 0, rc = 0;
    const uint64_t mask = (k >= 32) ? MAXU : ((1ULL << (2 * k)) - 1);
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; i++) {
        uint64_t c = (uint64_t)(uint8_t)codes[i];
        if (c > 3) { last_bad = i; c &= 3ULL; }  // numpy path uses code & 3
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((3ULL - c) << (2 * (k - 1)));
        if (i >= k - 1) {
            int64_t p = i - k + 1;
            if (last_bad >= p || fwd == rc) {
                h[p] = MAXU;
                str[p] = (int8_t)(rc < fwd);
            } else {
                h[p] = hs_mix64(std::min(fwd, rc));
                str[p] = (int8_t)(rc < fwd);
            }
        }
    }
    int64_t cnt = 0;
    if (m <= w) {
        int64_t best = 0;
        for (int64_t i = 1; i < m; i++)
            if (h[i] < h[best]) best = i;
        if (h[best] != MAXU) {
            out_pos[cnt] = best; out_hash[cnt] = h[best]; out_strand[cnt] = str[best]; cnt++;
        }
        return cnt;
    }
    std::vector<int64_t> dq(m);
    int64_t head = 0, tail = 0, last_emit = -1;
    for (int64_t i = 0; i < m; i++) {
        while (tail > head && h[dq[tail - 1]] > h[i]) tail--;
        dq[tail++] = i;
        if (dq[head] <= i - w) head++;
        if (i >= w - 1) {
            int64_t idx = dq[head];
            if (idx != last_emit) {
                last_emit = idx;
                if (h[idx] != MAXU) {
                    out_pos[cnt] = idx; out_hash[cnt] = h[idx]; out_strand[cnt] = str[idx]; cnt++;
                }
            }
        }
    }
    return cnt;
}

// ---------------------------------------------------------------------------
// Chain sweep (seeding.py:chain_anchors break loop, bit-identical): anchors
// sorted by t; break where the target jumps > max_gap or the EWMA-tracked
// diagonal drifts > max_diag_diff. Returns the number of boundary entries
// written to `breaks` (first 0, last n).
static inline int64_t hs_floordiv4(int64_t x) {
    return (x >= 0) ? x / 4 : -((-x + 3) / 4);
}

int64_t hs_chain_sweep(const int64_t* q, const int64_t* t, int64_t n,
                       int64_t max_gap, int64_t max_diag_diff, int64_t* breaks) {
    int64_t nb = 0;
    breaks[nb++] = 0;
    if (n == 0) { breaks[nb++] = 0; return nb; }
    int64_t ref = t[0] - q[0];
    for (int64_t i = 1; i < n; i++) {
        int64_t d = t[i] - q[i];
        int64_t drift = d - ref;
        if (t[i] - t[i - 1] > max_gap || (drift < 0 ? -drift : drift) > max_diag_diff) {
            breaks[nb++] = i;
            ref = d;
        } else {
            ref = hs_floordiv4(ref * 3 + d);  // Python // semantics
        }
    }
    breaks[nb++] = n;
    return nb;
}

// ---------------------------------------------------------------------------
// Pin selection (mapping.py:select_pins, bit-identical incl. Python round()
// banker's rounding in desert interpolation). Writes (q,t) pairs into
// out_qt[2*cap]; returns the pin count, or -1 if cap would overflow.
static inline int64_t hs_py_round(int64_t num, int64_t den) {
    // round(num/den) with ties-to-even; num >= 0, den > 0
    int64_t fl = num / den;
    int64_t rem2 = 2 * (num - fl * den);
    if (rem2 > den) return fl + 1;
    if (rem2 < den) return fl;
    return (fl % 2 == 0) ? fl : fl + 1;
}

static inline int64_t hs_ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t hs_select_pins(const int64_t* qa, const int64_t* ta, int64_t n,
                       int64_t B, int64_t T, int64_t md, int64_t cap,
                       int64_t* out_qt) {
    int64_t np_pins = 0;
    auto push = [&](int64_t qv, int64_t tv) -> bool {
        if (np_pins >= cap) return false;
        out_qt[2 * np_pins] = qv;
        out_qt[2 * np_pins + 1] = tv;
        np_pins++;
        return true;
    };
    if (!push(qa[0], ta[0])) return -1;
    int64_t idx = 0;
    const int64_t md1 = md > 1 ? md : 1;
    while (idx < n - 1) {
        int64_t best = -1;
        for (int64_t j2 = idx + 1; j2 < n; j2++) {
            int64_t dq = qa[j2] - qa[idx];
            int64_t dt = ta[j2] - ta[idx];
            int64_t drift = dt - dq;
            if (dq > B || dt > T || (drift < 0 ? -drift : drift) > md) break;
            best = j2;
        }
        if (best < 0) {
            int64_t nxt = idx + 1;
            int64_t dq = qa[nxt] - qa[idx];
            int64_t dt = ta[nxt] - ta[idx];
            int64_t drift = dt - dq;
            int64_t npieces = hs_ceil_div(dq, B);
            npieces = std::max(npieces, hs_ceil_div(dt, T));
            npieces = std::max(npieces, hs_ceil_div(drift < 0 ? -drift : drift, md1));
            npieces = std::max(npieces, (int64_t)1);
            for (int64_t mstep = 1; mstep <= npieces; mstep++) {
                if (!push(qa[idx] + hs_py_round(dq * mstep, npieces),
                          ta[idx] + hs_py_round(dt * mstep, npieces)))
                    return -1;
            }
            idx = nxt;
        } else {
            if (!push(qa[best], ta[best])) return -1;
            idx = best;
        }
    }
    return np_pins;
}

// ---------------------------------------------------------------------------
// Traceback-token expansion (ops/align_device.py:expand_rows_host, bit-
// identical). Decodes the per-row (d, up) tokens of the row-lockstep device
// traceback into forward-order expanded op streams (0 '=', 1 'X', 2 'I',
// 3 'D'). toks is N*B uint8 (row r at column r-1, value d | up<<7), meta is
// N*4 int32 (cost, clip, start_i, start_b), qb N*B and tb N*T int8 codes.
// Writes the concatenated streams into ops_out (capacity cap) and the N+1
// prefix offsets; returns total ops or -1 on overflow.
// Fused minimizer-index probe (native twin of MinimizerIndex.lookup's
// two searchsorted + repeat/arange expansion): for each query hash, binary
// search the sorted index hashes and emit (query idx, index offset) hits,
// skipping hashes more frequent than max_occ. Returns the hit count, or -1
// if cap would overflow (caller falls back to the numpy path).
int64_t hs_index_lookup(const uint64_t* ih, int64_t n_index,
                        const uint64_t* qh, int64_t n_q,
                        int64_t max_occ, int64_t cap,
                        int64_t* out_qidx, int64_t* out_at) {
    int64_t outn = 0;
    const uint64_t* end = ih + n_index;
    for (int64_t i = 0; i < n_q; i++) {
        uint64_t h = qh[i];
        const uint64_t* lo = std::lower_bound(ih, end, h);
        if (lo == end || *lo != h) continue;
        const uint64_t* hi = std::upper_bound(lo, end, h);
        int64_t cnt = hi - lo;
        if (cnt > max_occ) continue;
        if (outn + cnt > cap) return -1;
        int64_t base = lo - ih;
        for (int64_t k = 0; k < cnt; k++) {
            out_qidx[outn] = i;
            out_at[outn] = base + k;
            outn++;
        }
    }
    return outn;
}

int64_t hs_expand_rows(const uint8_t* toks, const int32_t* meta,
                       const int8_t* qb, const int8_t* tb,
                       int64_t N, int64_t B, int64_t T, int64_t dl,
                       int64_t cap, int8_t* ops_out, int64_t* offsets) {
    const int8_t TB_EQ = 0, TB_X = 1, TB_I = 2, TB_D = 3;
    std::vector<int32_t> row_d(B), row_up(B), row_nl(B);
    int64_t total = 0;
    for (int64_t n = 0; n < N; n++) {
        offsets[n] = total;
        const uint8_t* tk = toks + n * B;
        const int8_t* q = qb + n * B;
        const int8_t* t = tb + n * T;
        int64_t start_i = meta[4 * n + 2];
        int64_t start_b = meta[4 * n + 3];
        // pass 1: walk rows start_i..1 recovering band positions
        int64_t b = start_b;
        for (int64_t r = start_i; r >= 1; r--) {
            int32_t d = tk[r - 1] & 0x7f;
            int32_t up = tk[r - 1] >> 7;
            row_d[r - 1] = d;
            row_up[r - 1] = up;
            row_nl[r - 1] = (int32_t)(b - d);
            b = (b - d) + up;
        }
        int64_t jf = b - dl > 0 ? b - dl : 0;
        if (total + jf + start_i > cap) return -1;  // d-run bound checked below
        // pass 2: emit forward order
        for (int64_t k = 0; k < jf; k++) ops_out[total++] = TB_D;
        for (int64_t r = 1; r <= start_i; r++) {
            int64_t jcol = r + row_nl[r - 1] - dl;
            int8_t op;
            if (row_up[r - 1]) {
                op = TB_I;
            } else {
                int64_t tj = jcol - 1;
                if (tj < 0) tj = 0;
                if (tj > T - 1) tj = T - 1;
                op = (q[r - 1] == t[tj]) ? TB_EQ : TB_X;
            }
            int64_t need = 1 + row_d[r - 1];
            if (total + need > cap) return -1;
            ops_out[total++] = op;
            for (int32_t k = 0; k < row_d[r - 1]; k++) ops_out[total++] = TB_D;
        }
    }
    offsets[N] = total;
    return total;
}

// ---------------------------------------------------------------------------
// Partial-order-alignment consensus (racon/spoa equivalent; the reference
// shells out to racon for per-group window polishing, src/tools.cpp:317-557).
// Sequences are int8 base codes 0..3; the first sequence seeds the graph
// (the backbone window layer, like racon's window sequence). Each further
// sequence is aligned to the DAG (semi-global: graph prefix/suffix free,
// sequence fully consumed) and threaded in, fusing matching bases into
// existing nodes and keeping mismatches as aligned alternatives in the same
// column. The consensus is the heaviest path by edge weight, end-trimmed
// where node support falls below half the layer count (racon's window
// coverage trim).

}  // extern "C" (resumed after the POA templates, which need C++ linkage)

namespace poa {

struct Node {
    int8_t base;
    std::vector<std::pair<int32_t, int32_t>> in;  // (src, weight)
    std::vector<int32_t> out;
    std::vector<int32_t> aligned;  // other nodes of the same column
    int32_t support = 0;           // sequences that placed a base on this node
};

struct Graph {
    std::vector<Node> nodes;

    int32_t add_node(int8_t b) {
        nodes.push_back(Node{b, {}, {}, {}, 0});
        return (int32_t)nodes.size() - 1;
    }

    void add_edge(int32_t u, int32_t v, int32_t w) {
        for (auto& e : nodes[v].in)
            if (e.first == u) {
                e.second += w;
                return;
            }
        nodes[v].in.push_back({u, w});
        nodes[u].out.push_back(v);
    }

    std::vector<int32_t> topo() const {
        int32_t n = (int32_t)nodes.size();
        std::vector<int32_t> indeg(n, 0), order;
        order.reserve(n);
        for (int32_t v = 0; v < n; v++) indeg[v] = (int32_t)nodes[v].in.size();
        std::vector<int32_t> stack;
        for (int32_t v = 0; v < n; v++)
            if (indeg[v] == 0) stack.push_back(v);
        while (!stack.empty()) {
            int32_t v = stack.back();
            stack.pop_back();
            order.push_back(v);
            for (int32_t w : nodes[v].out)
                if (--indeg[w] == 0) stack.push_back(w);
        }
        return order;
    }
};

// Align seq (length m) to the graph (semi-global: graph prefix/suffix free,
// sequence fully consumed); returns pairs (node_id, seq_pos), -1 for gaps,
// in forward order. Score-matrix-only formulation: moves are re-derived at
// backtrack from H (checked in a fixed priority order), the left-run
// dependency is resolved with the prefix-max transform (H - j*gap is
// monotone under inserts), and single-pred chain nodes — the vast majority —
// take a branch-free inner loop. ws is a reusable workspace.
template <typename ST>
struct AlignWorkspace {
    std::vector<ST> H;
    std::vector<int32_t> order, rank_of;
    std::vector<std::pair<int32_t, int32_t>> rev;
    std::vector<ST> sb;  // [6][m] per-base substitution scores
    std::vector<ST> jg;  // j*gap, j = 0..m+1
};

// Left insert-run scan: row[j] = max(row[j], row[j-1] + gap), row[0] = 0.
// Equivalent max-plus prefix: with b[j] = row[j] - j*gap (b[0] = -jg[0] = 0),
// row[j] = jg[j] + prefix_max(b)[j] — a blockwise-parallel form the AVX2
// path exploits (3 shifted maxes per 8 lanes + a carried block max).
static inline void run_scan(int32_t* row, const int32_t* jg, int64_t m, int32_t gap) {
    int64_t j = 1;
#if defined(__AVX512F__)
    if (m >= 32) {
        const __m512i minv = _mm512_set1_epi32(INT32_MIN);
        const __m512i bidx = _mm512_set1_epi32(15);
        __m512i vcarry = _mm512_setzero_si512();  // running prefix max of b
        for (; j + 15 <= m; j += 16) {
            __m512i vr = _mm512_loadu_si512((const void*)(row + j));
            __m512i vj = _mm512_loadu_si512((const void*)(jg + j));
            __m512i b = _mm512_sub_epi32(vr, vj);
            b = _mm512_max_epi32(b, _mm512_alignr_epi32(b, minv, 15));
            b = _mm512_max_epi32(b, _mm512_alignr_epi32(b, minv, 14));
            b = _mm512_max_epi32(b, _mm512_alignr_epi32(b, minv, 12));
            b = _mm512_max_epi32(b, _mm512_alignr_epi32(b, minv, 8));
            b = _mm512_max_epi32(b, vcarry);
            vcarry = _mm512_permutexvar_epi32(bidx, b);
            _mm512_storeu_si512((void*)(row + j), _mm512_add_epi32(b, vj));
        }
        int32_t run = _mm_cvtsi128_si32(_mm512_castsi512_si128(vcarry)) + jg[j - 1];
        for (; j <= m; j++) {
            int32_t v = row[j];
            int32_t ins = run + gap;
            run = v > ins ? v : ins;
            row[j] = run;
        }
        return;
    }
#endif
#if defined(__AVX2__)
    if (m >= 16) {
        const __m256i minv = _mm256_set1_epi32(INT32_MIN);
        __m256i vcarry = _mm256_setzero_si256();  // running prefix max of b
        for (; j + 7 <= m; j += 8) {
            __m256i vr = _mm256_loadu_si256((const __m256i*)(row + j));
            __m256i vj = _mm256_loadu_si256((const __m256i*)(jg + j));
            __m256i b = _mm256_sub_epi32(vr, vj);
            b = _mm256_max_epi32(b, _mm256_alignr_epi8(b, minv, 12));
            b = _mm256_max_epi32(b, _mm256_alignr_epi8(b, minv, 8));
            // propagate the low 128-lane's last prefix into the high lane
            __m256i t = _mm256_shuffle_epi32(b, 0xFF);
            __m256i lo = _mm256_permute2x128_si256(t, t, 0x00);
            lo = _mm256_blend_epi32(lo, minv, 0x0F);
            b = _mm256_max_epi32(b, lo);
            b = _mm256_max_epi32(b, vcarry);
            __m256i t2 = _mm256_shuffle_epi32(b, 0xFF);
            vcarry = _mm256_permute2x128_si256(t2, t2, 0x11);
            _mm256_storeu_si256((__m256i*)(row + j), _mm256_add_epi32(b, vj));
        }
        int32_t run = _mm256_extract_epi32(vcarry, 0) + jg[j - 1];
        for (; j <= m; j++) {
            int32_t v = row[j];
            int32_t ins = run + gap;
            run = v > ins ? v : ins;
            row[j] = run;
        }
        return;
    }
#endif
    int32_t run = 0;
    for (; j <= m; j++) {
        int32_t v = row[j];
        int32_t ins = run + gap;
        run = v > ins ? v : ins;
        row[j] = run;
    }
}

// int16 variant of the scan (values are exact in int16 by the caller's
// range guard, so max/add never saturate on real candidates).
static inline void run_scan(int16_t* row, const int16_t* jg, int64_t m, int32_t gap) {
    int64_t j = 1;
#if defined(__AVX2__)
    if (m >= 32) {
        const __m256i minv = _mm256_set1_epi16(INT16_MIN);
        const __m256i bc7 = _mm256_set1_epi16(0x0F0E);  // per-lane elem-7 broadcast
        __m256i vcarry = _mm256_setzero_si256();        // running prefix max of b
        for (; j + 15 <= m; j += 16) {
            __m256i vr = _mm256_loadu_si256((const __m256i*)(row + j));
            __m256i vj = _mm256_loadu_si256((const __m256i*)(jg + j));
            __m256i b = _mm256_sub_epi16(vr, vj);
            b = _mm256_max_epi16(b, _mm256_alignr_epi8(b, minv, 14));
            b = _mm256_max_epi16(b, _mm256_alignr_epi8(b, minv, 12));
            b = _mm256_max_epi16(b, _mm256_alignr_epi8(b, minv, 8));
            // propagate the low 128-lane's last prefix into the high lane
            __m256i t = _mm256_shuffle_epi8(b, bc7);
            __m256i lo = _mm256_permute2x128_si256(t, t, 0x00);
            lo = _mm256_blend_epi32(lo, minv, 0x0F);
            b = _mm256_max_epi16(b, lo);
            b = _mm256_max_epi16(b, vcarry);
            __m256i t2 = _mm256_shuffle_epi8(b, bc7);
            vcarry = _mm256_permute2x128_si256(t2, t2, 0x11);
            _mm256_storeu_si256((__m256i*)(row + j), _mm256_add_epi16(b, vj));
        }
        int32_t run = (int16_t)_mm256_extract_epi16(vcarry, 0) + (int32_t)jg[j - 1];
        for (; j <= m; j++) {
            int32_t v = row[j];
            int32_t ins = run + gap;
            run = v > ins ? v : ins;
            row[j] = (int16_t)run;
        }
        return;
    }
#endif
    int32_t run = 0;
    for (; j <= m; j++) {
        int32_t v = row[j];
        int32_t ins = run + gap;
        run = v > ins ? v : ins;
        row[j] = (int16_t)run;
    }
}

template <typename ST>
static void align_to_graph(const Graph& g, const int8_t* seq, int64_t m,
                           int32_t match, int32_t mismatch, int32_t gap,
                           AlignWorkspace<ST>& ws,
                           std::vector<std::pair<int32_t, int32_t>>& pairs) {
    pairs.clear();
    {
        std::vector<int32_t> t = g.topo();
        ws.order.assign(t.begin(), t.end());
    }
    int32_t R = (int32_t)ws.order.size();
    ws.rank_of.resize(R);
    for (int32_t r = 0; r < R; r++) ws.rank_of[ws.order[r]] = r;
    int64_t stride = m + 1;
    ws.H.resize((int64_t)(R + 1) * stride);
    ST* H = ws.H.data();
    for (int64_t j = 0; j <= m; j++) H[j] = (ST)((int32_t)j * gap);
    // hoisted per-row constants: sb[b][j] = subst score of base b at seq[j],
    // jg[j] = j*gap (both affine streams the fill loops read contiguously)
    ws.sb.resize(6 * m);
    for (int32_t b = 0; b < 6; b++) {
        ST* row = ws.sb.data() + (int64_t)b * m;
        for (int64_t j = 0; j < m; j++) row[j] = (ST)((seq[j] == b) ? match : mismatch);
    }
    ws.jg.resize(m + 2);
    for (int64_t j = 0; j <= m + 1; j++) ws.jg[j] = (ST)((int32_t)j * gap);
    const ST* jg = ws.jg.data();
    const ST gapS = (ST)gap;
    for (int32_t r = 0; r < R; r++) {
        const Node& nd = g.nodes[ws.order[r]];
        ST* row = H + (int64_t)(r + 1) * stride;
        const int32_t bb = nd.base >= 0 && nd.base < 6 ? nd.base : 5;
        const ST* sb = ws.sb.data() + (int64_t)bb * m;
        int32_t npred = (int32_t)nd.in.size();
        row[0] = 0;  // free graph prefix, no seq consumed
        // Two-pass fill, identical H to the sequential recurrence: the
        // insert-run candidate row[j-1]+gap distributes over the max, so
        // pass 1 computes every run-free candidate (vectorizes: affine
        // loads + vpmaxs[dw]) and pass 2 is the max-plus left scan.
        if (npred == 1) {
            const ST* prow = H + (int64_t)(ws.rank_of[nd.in[0].first] + 1) * stride;
            // pred diag/del + virtual source (fresh start after j-1 inserts)
            for (int64_t j = 1; j <= m; j++) {
                ST sc = sb[j - 1];
                ST cand = (ST)(prow[j - 1] + sc);
                ST cu = (ST)(prow[j] + gapS);
                cand = cu > cand ? cu : cand;
                ST s0 = (ST)(jg[j - 1] + sc);  // source diag
                cand = s0 > cand ? s0 : cand;
                ST s1 = jg[j + 1];  // source del (j*gap + gap)
                cand = s1 > cand ? s1 : cand;
                row[j] = cand;
            }
        } else {
            for (int64_t j = 1; j <= m; j++) {
                ST sc = sb[j - 1];
                ST cand = (ST)(jg[j - 1] + sc);  // source diag
                ST s1 = jg[j + 1];               // source del
                row[j] = s1 > cand ? s1 : cand;
            }
            for (int32_t pi = 0; pi < npred; pi++) {
                const ST* prow =
                    H + (int64_t)(ws.rank_of[nd.in[pi].first] + 1) * stride;
                for (int64_t j = 1; j <= m; j++) {
                    ST cand = row[j];
                    ST cd = (ST)(prow[j - 1] + sb[j - 1]);
                    cand = cd > cand ? cd : cand;
                    ST cu = (ST)(prow[j] + gapS);
                    cand = cu > cand ? cu : cand;
                    row[j] = cand;
                }
            }
        }
        run_scan(row, jg, m, gap);
    }
    // free graph suffix: best over all rows at j == m
    int32_t best_r = -1, best_v = (int32_t)H[m];
    for (int32_t r = 0; r < R; r++) {
        int32_t v = (int32_t)H[(int64_t)(r + 1) * stride + m];
        if (v > best_v) { best_v = v; best_r = r; }
    }
    // backtrack: re-derive the move at each cell (fixed candidate order)
    auto& rev = ws.rev;
    rev.clear();
    int32_t r = best_r;
    int64_t j = m;
    while (true) {
        if (r < 0) {  // at the virtual source: leading inserts remain
            while (j > 0) { rev.push_back({-1, (int32_t)(j - 1)}); j--; }
            break;
        }
        const ST* row = H + (int64_t)(r + 1) * stride;
        if (j == 0) break;  // free graph prefix
        int32_t v = (int32_t)row[j];
        const Node& nd = g.nodes[ws.order[r]];
        int32_t sc = (nd.base == seq[j - 1]) ? match : mismatch;
        // 1. fresh start (source diag), ends the walk
        if (v == (int32_t)(j - 1) * gap + sc) {
            rev.push_back({ws.order[r], (int32_t)(j - 1)});
            j--;
            while (j > 0) { rev.push_back({-1, (int32_t)(j - 1)}); j--; }
            break;
        }
        // 2. source del
        if (v == (int32_t)j * gap + gap) {
            rev.push_back({ws.order[r], -1});
            while (j > 0) { rev.push_back({-1, (int32_t)(j - 1)}); j--; }
            break;
        }
        // 3. graph preds (diag then del, in edge order)
        int32_t next_r = INT32_MIN;
        for (auto& e : nd.in) {
            const ST* prow = H + (int64_t)(ws.rank_of[e.first] + 1) * stride;
            if (v == prow[j - 1] + sc) {
                rev.push_back({ws.order[r], (int32_t)(j - 1)});
                j--;
                next_r = ws.rank_of[e.first];
                break;
            }
            if (v == prow[j] + gap) {
                rev.push_back({ws.order[r], -1});
                next_r = ws.rank_of[e.first];
                break;
            }
        }
        if (next_r != INT32_MIN) { r = next_r; continue; }
        // 4. insert (stay on this node's row)
        rev.push_back({-1, (int32_t)(j - 1)});
        j--;
    }
    pairs.assign(rev.rbegin(), rev.rend());
}

static void add_alignment(Graph& g, const int8_t* seq, int64_t m,
                          const std::vector<std::pair<int32_t, int32_t>>& pairs) {
    int32_t prev = -1;
    for (auto& pr : pairs) {
        int32_t nid = pr.first;
        int32_t j = pr.second;
        if (j < 0) continue;  // graph node skipped: nothing to add
        int8_t c = seq[j];
        int32_t cur;
        if (nid < 0) {
            cur = g.add_node(c);
        } else if (g.nodes[nid].base == c) {
            cur = nid;
        } else {
            cur = -1;
            for (int32_t a : g.nodes[nid].aligned)
                if (g.nodes[a].base == c) { cur = a; break; }
            if (cur < 0) {
                cur = g.add_node(c);
                std::vector<int32_t> members(g.nodes[nid].aligned);
                members.push_back(nid);
                for (int32_t mmb : members) g.nodes[mmb].aligned.push_back(cur);
                g.nodes[cur].aligned = members;
            }
        }
        g.nodes[cur].support++;
        if (prev >= 0) g.add_edge(prev, cur, 1);
        prev = cur;
    }
}

struct PoaScratch {
    AlignWorkspace<int16_t> ws16;
    AlignWorkspace<int32_t> ws32;
    std::vector<std::pair<int32_t, int32_t>> pairs;
};

// One window's POA consensus (the hs_poa_consensus body, scratch reusable
// across windows). Scores are computed in int16 when the score range
// provably fits (the common racon-window case: halves H-matrix bandwidth
// and doubles SIMD lanes; H values are exact either way).
static int64_t poa_window(const int8_t* seqs, const int64_t* offsets, int64_t n_seqs,
                          int32_t match, int32_t mismatch, int32_t gap,
                          int32_t min_cov, int8_t* out, int64_t cap, PoaScratch& scr);

}  // namespace poa

extern "C" int64_t hs_poa_consensus(const int8_t* seqs, const int64_t* offsets,
                                    int64_t n_seqs, int32_t match, int32_t mismatch,
                                    int32_t gap, int32_t min_cov, int8_t* out,
                                    int64_t cap) {
    poa::PoaScratch scr;
    return poa::poa_window(seqs, offsets, n_seqs, match, mismatch, gap, min_cov, out, cap, scr);
}

namespace poa {

static int64_t poa_window(const int8_t* seqs, const int64_t* offsets, int64_t n_seqs,
                          int32_t match, int32_t mismatch, int32_t gap,
                          int32_t min_cov, int8_t* out, int64_t cap, PoaScratch& scr) {
    if (n_seqs <= 0) return 0;
    poa::Graph g;
    // seed with the first sequence (backbone window layer)
    {
        int64_t lo = offsets[0], hi = offsets[1];
        int32_t prev = -1;
        for (int64_t p = lo; p < hi; p++) {
            int32_t v = g.add_node(seqs[p]);
            g.nodes[v].support++;
            if (prev >= 0) g.add_edge(prev, v, 1);
            prev = v;
        }
    }
    std::vector<std::pair<int32_t, int32_t>>& pairs = scr.pairs;
    const int32_t maxsc = std::max(std::max(std::abs(match), std::abs(mismatch)), std::abs(gap));
    for (int64_t s = 1; s < n_seqs; s++) {
        int64_t lo = offsets[s], hi = offsets[s + 1];
        if (hi <= lo) continue;
        int64_t m = hi - lo;
        if ((m + 2) * (int64_t)(maxsc + std::abs(gap)) < 32000)
            poa::align_to_graph(g, seqs + lo, m, match, mismatch, gap, scr.ws16, pairs);
        else
            poa::align_to_graph(g, seqs + lo, m, match, mismatch, gap, scr.ws32, pairs);
        poa::add_alignment(g, seqs + lo, hi - lo, pairs);
    }
    // heaviest path by edge weight (ties: higher upstream score)
    std::vector<int32_t> order = g.topo();
    int64_t n = (int64_t)g.nodes.size();
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> pred(n, -1);
    for (int32_t v : order) {
        int64_t best = 0;
        int32_t bp = -1;
        int64_t bw = -1;
        for (auto& e : g.nodes[v].in) {
            int64_t cand = score[e.first] + e.second;
            if (e.second > bw || (e.second == bw && cand > best)) {
                bw = e.second;
                best = cand;
                bp = e.first;
            }
        }
        if (bp >= 0) { score[v] = best; pred[v] = bp; }
    }
    int32_t end = 0;
    for (int32_t v = 0; v < (int32_t)n; v++)
        if (score[v] > score[end]) end = v;
    std::vector<int32_t> path;
    for (int32_t v = end; v >= 0; v = pred[v]) path.push_back(v);
    std::reverse(path.begin(), path.end());
    // racon-style coverage trim at the ends
    int64_t b = 0, e = (int64_t)path.size();
    while (b < e && g.nodes[path[b]].support < min_cov) b++;
    while (e > b && g.nodes[path[e - 1]].support < min_cov) e--;
    int64_t outn = 0;
    for (int64_t i = b; i < e; i++) {
        if (outn >= cap) return -1;
        out[outn++] = g.nodes[path[i]].base;
    }
    return outn;
}

}  // namespace poa

// Batched windowed POA: windows are independent (racon's unit of work), so
// they are striped across worker threads, each with its own reusable
// scratch. Layer layout is flat: window w owns layers
// [win_layer_off[w], win_layer_off[w+1]) of `offsets`; its consensus is
// written at out + out_off[w] (region size out_off[w+1]-out_off[w]) with the
// actual length in out_lens[w] (-1 = region overflow).
extern "C" int64_t hs_poa_consensus_batch(const int8_t* seqs, const int64_t* offsets,
                               const int64_t* win_layer_off, int64_t n_windows,
                               int32_t match, int32_t mismatch, int32_t gap,
                               const int32_t* min_covs, int8_t* out,
                               const int64_t* out_off, int64_t* out_lens,
                               int32_t n_threads) {
    if (n_windows <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_windows) n_threads = (int32_t)n_windows;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        poa::PoaScratch scr;
        while (true) {
            int64_t w = next.fetch_add(1);
            if (w >= n_windows) break;
            int64_t lo = win_layer_off[w], hi = win_layer_off[w + 1];
            out_lens[w] = poa::poa_window(seqs, offsets + lo, hi - lo, match, mismatch,
                                          gap, min_covs[w], out + out_off[w],
                                          out_off[w + 1] - out_off[w], scr);
        }
    };
    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int32_t t = 0; t < n_threads; t++) threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }
    return 0;
}
