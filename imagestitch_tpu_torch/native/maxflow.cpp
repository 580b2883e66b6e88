// Native min-cut / max-flow for the GraphCut seam finder.
//
// The reference drivers default to OpenCV's GraphCutSeamFinder(COST_COLOR)
// (ref 特征点检测.cpp:1128-1136). Min-cut on a 4-connected pixel grid is
// inherently sequential/irregular (augmenting paths), so like the CCL
// kernels it lives in the native (C++) runtime rather than on the TPU.
//
// Algorithm: Boykov–Kolmogorov with search-tree reuse (the standard choice
// for vision grids). The graph is a dense H x W 4-neighbor grid:
//   tcap[i]        : terminal capacity (>0: source surplus, <0: sink)
//   ecap[i][d]     : directed residual capacity to neighbor d
//                    (d: 0=left, 1=right, 2=up, 3=down)
// After maxflow, label[i] = 1 if node i is reachable from the source
// (belongs to image 1's side), else 0.
//
// Build: part of libccl.so (see build in ccl.py — both files are compiled
// into one shared object).

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr int32_t kNone = -1;
constexpr int32_t kTerminal = -2;

struct Grid {
    int64_t h, w, n;
    std::vector<float> tcap;          // terminal residual
    std::vector<float> ecap;          // n*4 edge residuals
    std::vector<int32_t> parent;      // parent node (kTerminal for roots)
    std::vector<int8_t> parent_dir;   // direction from parent to this node
    std::vector<int8_t> tree;         // 0 free, 1 source, 2 sink
    std::vector<uint32_t> ts;         // timestamp
    std::vector<int32_t> dist;        // distance to terminal
    std::deque<int32_t> active;
    std::deque<int32_t> orphans;
    uint32_t time = 0;

    int64_t nb(int64_t i, int d) const {
        switch (d) {
            case 0: return (i % w) > 0 ? i - 1 : -1;
            case 1: return (i % w) < w - 1 ? i + 1 : -1;
            case 2: return i >= w ? i - w : -1;
            default: return i + w < n ? i + w : -1;
        }
    }
    static int rev(int d) { return d ^ 1; }  // 0<->1, 2<->3

    // residual from u toward v in direction d, respecting tree orientation
    float& cap_out(int64_t u, int d) { return ecap[u * 4 + d]; }
};

}  // namespace

extern "C" {

// Runs BK maxflow on the grid; writes labels (1 = source side). Returns the
// total flow value.
double grid_maxflow(const float* tcap_in, const float* ecap_in,
                    int64_t h, int64_t w, uint8_t* label_out) {
    Grid g;
    g.h = h;
    g.w = w;
    g.n = h * w;
    g.tcap.assign(tcap_in, tcap_in + g.n);
    g.ecap.assign(ecap_in, ecap_in + g.n * 4);
    g.parent.assign(g.n, kNone);
    g.parent_dir.assign(g.n, 0);
    g.tree.assign(g.n, 0);
    g.ts.assign(g.n, 0);
    g.dist.assign(g.n, 0);

    double flow = 0.0;

    // init: all nodes with nonzero terminal capacity become roots
    for (int64_t i = 0; i < g.n; ++i) {
        if (g.tcap[i] > 0) {
            g.tree[i] = 1;
            g.parent[i] = kTerminal;
            g.dist[i] = 1;
            g.active.push_back(static_cast<int32_t>(i));
        } else if (g.tcap[i] < 0) {
            g.tree[i] = 2;
            g.parent[i] = kTerminal;
            g.dist[i] = 1;
            g.active.push_back(static_cast<int32_t>(i));
        }
    }

    auto tree_cap = [&](int64_t from, int d, int8_t which) -> float {
        // residual in the growth direction for tree `which`
        if (which == 1) return g.cap_out(from, d);
        int64_t v = g.nb(from, d);
        return g.cap_out(v, Grid::rev(d));
    };

    while (true) {
        // ---- grow ----
        int64_t meet_u = -1;
        int meet_d = -1;
        while (!g.active.empty()) {
            int64_t p = g.active.front();
            if (g.tree[p] == 0) {  // stale
                g.active.pop_front();
                continue;
            }
            bool found = false;
            for (int d = 0; d < 4 && !found; ++d) {
                int64_t q = g.nb(p, d);
                if (q < 0) continue;
                float c = (g.tree[p] == 1) ? g.cap_out(p, d)
                                           : g.cap_out(q, Grid::rev(d));
                if (c <= 0) continue;
                if (g.tree[q] == 0) {
                    g.tree[q] = g.tree[p];
                    g.parent[q] = static_cast<int32_t>(p);
                    g.parent_dir[q] = static_cast<int8_t>(d);
                    g.ts[q] = g.ts[p];
                    g.dist[q] = g.dist[p] + 1;
                    g.active.push_back(static_cast<int32_t>(q));
                } else if (g.tree[q] != g.tree[p]) {
                    // path found between trees
                    meet_u = (g.tree[p] == 1) ? p : q;
                    meet_d = (g.tree[p] == 1) ? d : Grid::rev(d);
                    found = true;
                }
            }
            if (found) break;
            g.active.pop_front();
        }
        if (meet_u < 0) break;  // no augmenting path: done

        // ---- augment ----
        // bottleneck along: source tree path, bridge, sink tree path
        int64_t v_sink = g.nb(meet_u, meet_d);
        float bottleneck = g.cap_out(meet_u, meet_d);
        for (int64_t u = meet_u; g.parent[u] != kTerminal;
             u = g.parent[u]) {
            int64_t par = g.parent[u];
            int d = g.parent_dir[u];
            float c = g.cap_out(par, d);
            if (c < bottleneck) bottleneck = c;
        }
        {
            int64_t root = meet_u;
            while (g.parent[root] != kTerminal) root = g.parent[root];
            if (g.tcap[root] < bottleneck) bottleneck = g.tcap[root];
        }
        for (int64_t u = v_sink; g.parent[u] != kTerminal;
             u = g.parent[u]) {
            int64_t par = g.parent[u];
            int d = g.parent_dir[u];
            float c = g.cap_out(u, Grid::rev(d));
            if (c < bottleneck) bottleneck = c;
        }
        {
            int64_t root = v_sink;
            while (g.parent[root] != kTerminal) root = g.parent[root];
            float c = -g.tcap[root];
            if (c < bottleneck) bottleneck = c;
        }
        if (bottleneck <= 0) {  // degenerate; cut the bridge and continue
            // treat as saturated to make progress
            g.cap_out(meet_u, meet_d) = 0;
            continue;
        }
        flow += bottleneck;

        // capture both roots BEFORE applying: the apply loops orphan
        // saturated path nodes (parent = kNone), after which a root walk
        // would dereference parent[-1]
        int64_t src_root = meet_u;
        while (g.parent[src_root] != kTerminal) src_root = g.parent[src_root];
        int64_t snk_root = v_sink;
        while (g.parent[snk_root] != kTerminal) snk_root = g.parent[snk_root];

        // apply along bridge
        g.cap_out(meet_u, meet_d) -= bottleneck;
        g.cap_out(v_sink, Grid::rev(meet_d)) += bottleneck;
        // source side
        for (int64_t u = meet_u; g.parent[u] != kTerminal;) {
            int64_t par = g.parent[u];
            int d = g.parent_dir[u];
            g.cap_out(par, d) -= bottleneck;
            g.cap_out(u, Grid::rev(d)) += bottleneck;
            if (g.cap_out(par, d) <= 0) {
                g.parent[u] = kNone;
                g.orphans.push_back(static_cast<int32_t>(u));
            }
            u = par;
        }
        g.tcap[src_root] -= bottleneck;
        if (g.tcap[src_root] <= 0 && g.parent[src_root] == kTerminal) {
            g.parent[src_root] = kNone;
            g.orphans.push_back(static_cast<int32_t>(src_root));
        }
        // sink side
        for (int64_t u = v_sink; g.parent[u] != kTerminal;) {
            int64_t par = g.parent[u];
            int d = g.parent_dir[u];
            g.cap_out(u, Grid::rev(d)) -= bottleneck;
            g.cap_out(par, d) += bottleneck;
            if (g.cap_out(u, Grid::rev(d)) <= 0) {
                g.parent[u] = kNone;
                g.orphans.push_back(static_cast<int32_t>(u));
            }
            u = par;
        }
        g.tcap[snk_root] += bottleneck;  // tcap negative for sink roots
        if (g.tcap[snk_root] >= 0 && g.parent[snk_root] == kTerminal) {
            g.parent[snk_root] = kNone;
            g.orphans.push_back(static_cast<int32_t>(snk_root));
        }

        // ---- adopt ----
        ++g.time;
        while (!g.orphans.empty()) {
            int64_t o = g.orphans.front();
            g.orphans.pop_front();
            int8_t which = g.tree[o];
            // find a new valid parent
            int32_t best_par = kNone;
            int best_d = -1;
            int32_t best_dist = INT32_MAX;
            for (int d = 0; d < 4; ++d) {
                int64_t q = g.nb(o, d);
                if (q < 0 || g.tree[q] != which) continue;
                float c = (which == 1) ? g.cap_out(q, Grid::rev(d))
                                       : g.cap_out(o, d);
                if (c <= 0) continue;
                // check q's root connectivity, stamping distances along the
                // walked path (classic BK ORIGIN optimization — without it
                // adoption degenerates to quadratic and large grids hang)
                int64_t a = q;
                bool rooted = false;
                int32_t dd = 0;
                while (true) {
                    if (g.ts[a] == g.time) {
                        rooted = g.dist[a] != INT32_MAX;
                        dd += g.dist[a];
                        break;
                    }
                    if (g.parent[a] == kTerminal) {
                        g.ts[a] = g.time;
                        g.dist[a] = 1;
                        rooted = true;
                        dd += 1;
                        break;
                    }
                    if (g.parent[a] == kNone) {
                        rooted = false;
                        break;
                    }
                    a = g.parent[a];
                    ++dd;
                }
                if (!rooted) continue;
                // back-stamp the path with exact distances
                {
                    int32_t dcur = dd;
                    int64_t a2 = q;
                    while (!(g.ts[a2] == g.time && g.dist[a2] == dcur)) {
                        g.ts[a2] = g.time;
                        g.dist[a2] = dcur;
                        if (g.parent[a2] == kTerminal || g.parent[a2] == kNone)
                            break;
                        a2 = g.parent[a2];
                        --dcur;
                    }
                }
                if (dd < best_dist) {
                    best_dist = dd;
                    best_par = static_cast<int32_t>(q);
                    best_d = d;
                }
            }
            if (best_par != kNone) {
                g.parent[o] = best_par;
                g.parent_dir[o] = static_cast<int8_t>(Grid::rev(best_d));
                g.ts[o] = g.time;
                g.dist[o] = best_dist + 1;
            } else {
                // no parent: o becomes free; neighbors may orphan.
                // invalidate rootedness caches of every node cut here —
                // stale (ts == time, finite dist) entries would let later
                // origin walks adopt into a disconnected subtree (cycle)
                for (int d = 0; d < 4; ++d) {
                    int64_t q = g.nb(o, d);
                    if (q < 0 || g.tree[q] != which) continue;
                    float c = (which == 1) ? g.cap_out(q, Grid::rev(d))
                                           : g.cap_out(o, d);
                    if (c > 0) g.active.push_back(static_cast<int32_t>(q));
                    if (g.parent[q] == o) {
                        g.parent[q] = kNone;
                        g.ts[q] = g.time;
                        g.dist[q] = INT32_MAX;
                        g.orphans.push_back(static_cast<int32_t>(q));
                    }
                }
                g.tree[o] = 0;
                g.ts[o] = g.time;
                g.dist[o] = INT32_MAX;
            }
        }
    }

    // label: BFS from all source roots over residual graph
    std::vector<uint8_t> lab(g.n, 0);
    std::deque<int64_t> q;
    for (int64_t i = 0; i < g.n; ++i) {
        if (g.tcap[i] > 0) {
            lab[i] = 1;
            q.push_back(i);
        }
    }
    while (!q.empty()) {
        int64_t u = q.front();
        q.pop_front();
        for (int d = 0; d < 4; ++d) {
            int64_t v = g.nb(u, d);
            if (v >= 0 && !lab[v] && g.cap_out(u, d) > 0) {
                lab[v] = 1;
                q.push_back(v);
            }
        }
    }
    std::memcpy(label_out, lab.data(), g.n);
    return flow;
}

}  // extern "C"
