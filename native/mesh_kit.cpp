// mesh_kit: native host-side mesh preprocessing for small_fem_solver_tpu.
//
// JAX owns all numerics; this library covers the
// latency-sensitive host-side runtime work that sits in front of it:
//
//   * build_bcsr_pattern: block-sparsity pattern of the global stiffness
//     (unique (row, col) node blocks + per-element destination slots) in
//     O(M) with a hash map, replacing the numpy sort-based builder for
//     very large meshes;
//   * rcm_ordering: reverse Cuthill-McKee node permutation (bandwidth
//     reduction for banded/direct solvers and cache-friendly gathers);
//   * refine_members: coordinates + connectivity of chain-subdivided
//     members (the large-mesh generator) without Python overhead.
//
// C ABI only (ctypes-friendly); all buffers caller-allocated unless noted.
// Build: make -C native   (produces native/libmesh_kit.so)

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// Unique (i,i),(i,j),(j,i),(j,j) blocks over all elements, CSR-ordered.
// conn: [m, 2] int32. Outputs (caller-allocated, sized by *n_blocks from a
// first call with blocks_rows == nullptr):
//   block_rows/block_cols: [n_blocks] int32 (row-major sorted)
//   row_ptr: [n_nodes + 1] int64
//   elem_slot: [m, 4] int32
// Returns 0 on success.
int64_t bcsr_pattern_count(const int32_t* conn, int64_t m, int64_t n_nodes) {
    std::unordered_map<int64_t, int32_t> seen;
    seen.reserve(4 * m);
    for (int64_t e = 0; e < m; ++e) {
        int64_t i = conn[2 * e], j = conn[2 * e + 1];
        const int64_t keys[4] = {i * n_nodes + i, i * n_nodes + j,
                                 j * n_nodes + i, j * n_nodes + j};
        for (int64_t k : keys) seen.emplace(k, 0);
    }
    return static_cast<int64_t>(seen.size());
}

int bcsr_pattern_fill(const int32_t* conn, int64_t m, int64_t n_nodes,
                      int32_t* block_rows, int32_t* block_cols,
                      int64_t* row_ptr, int32_t* elem_slot,
                      int64_t n_blocks) {
    std::vector<int64_t> keys;
    keys.reserve(4 * m);
    {
        std::unordered_map<int64_t, int32_t> seen;
        seen.reserve(4 * m);
        for (int64_t e = 0; e < m; ++e) {
            int64_t i = conn[2 * e], j = conn[2 * e + 1];
            const int64_t kk[4] = {i * n_nodes + i, i * n_nodes + j,
                                   j * n_nodes + i, j * n_nodes + j};
            for (int64_t k : kk)
                if (seen.emplace(k, 0).second) keys.push_back(k);
        }
    }
    if (static_cast<int64_t>(keys.size()) != n_blocks) return 1;
    std::sort(keys.begin(), keys.end());

    std::unordered_map<int64_t, int32_t> slot;
    slot.reserve(keys.size());
    for (int64_t b = 0; b < n_blocks; ++b) {
        slot[keys[b]] = static_cast<int32_t>(b);
        block_rows[b] = static_cast<int32_t>(keys[b] / n_nodes);
        block_cols[b] = static_cast<int32_t>(keys[b] % n_nodes);
    }
    std::memset(row_ptr, 0, sizeof(int64_t) * (n_nodes + 1));
    for (int64_t b = 0; b < n_blocks; ++b) row_ptr[block_rows[b] + 1]++;
    for (int64_t r = 0; r < n_nodes; ++r) row_ptr[r + 1] += row_ptr[r];
    for (int64_t e = 0; e < m; ++e) {
        int64_t i = conn[2 * e], j = conn[2 * e + 1];
        elem_slot[4 * e + 0] = slot[i * n_nodes + i];
        elem_slot[4 * e + 1] = slot[i * n_nodes + j];
        elem_slot[4 * e + 2] = slot[j * n_nodes + i];
        elem_slot[4 * e + 3] = slot[j * n_nodes + j];
    }
    return 0;
}

// Reverse Cuthill-McKee ordering. perm: [n_nodes] int32 output
// (perm[new_index] = old_index).
int rcm_ordering(const int32_t* conn, int64_t m, int64_t n_nodes,
                 int32_t* perm) {
    std::vector<std::vector<int32_t>> adj(n_nodes);
    for (int64_t e = 0; e < m; ++e) {
        int32_t i = conn[2 * e], j = conn[2 * e + 1];
        if (i == j) continue;
        adj[i].push_back(j);
        adj[j].push_back(i);
    }
    for (auto& a : adj) {
        std::sort(a.begin(), a.end());
        a.erase(std::unique(a.begin(), a.end()), a.end());
    }
    std::vector<char> visited(n_nodes, 0);
    std::vector<int32_t> order;
    order.reserve(n_nodes);
    auto degree_less = [&](int32_t a, int32_t b) {
        return adj[a].size() < adj[b].size();
    };
    for (;;) {
        int32_t start = -1;
        for (int64_t v = 0; v < n_nodes; ++v)
            if (!visited[v] && (start < 0 || degree_less(v, start)))
                start = static_cast<int32_t>(v);
        if (start < 0) break;
        std::queue<int32_t> q;
        q.push(start);
        visited[start] = 1;
        while (!q.empty()) {
            int32_t v = q.front();
            q.pop();
            order.push_back(v);
            std::vector<int32_t> nb;
            for (int32_t u : adj[v])
                if (!visited[u]) nb.push_back(u);
            std::sort(nb.begin(), nb.end(), degree_less);
            for (int32_t u : nb) {
                visited[u] = 1;
                q.push(u);
            }
        }
    }
    std::reverse(order.begin(), order.end());
    for (int64_t v = 0; v < n_nodes; ++v) perm[v] = order[v];
    return 0;
}

// Chain subdivision: coords [n, 3] f64, conn [m, 2] i32, n_seg segments.
// Outputs: new_coords [n + m*(n_seg-1), 3], new_conn [m*n_seg, 2],
// new_sect [m*n_seg] (from sect [m]).
int refine_members(const double* coords, int64_t n,
                   const int32_t* conn, int64_t m,
                   const int32_t* sect, int32_t n_seg,
                   double* new_coords, int32_t* new_conn,
                   int32_t* new_sect) {
    std::memcpy(new_coords, coords, sizeof(double) * 3 * n);
    const int64_t n_int = n_seg - 1;
    for (int64_t e = 0; e < m; ++e) {
        const int32_t i = conn[2 * e], j = conn[2 * e + 1];
        const double* c1 = coords + 3 * i;
        const double* c2 = coords + 3 * j;
        for (int64_t k = 1; k < n_seg; ++k) {
            double* out = new_coords + 3 * (n + e * n_int + (k - 1));
            const double s = static_cast<double>(k) / n_seg;
            for (int d = 0; d < 3; ++d) out[d] = c1[d] + (c2[d] - c1[d]) * s;
        }
        for (int64_t k = 0; k < n_seg; ++k) {
            int32_t a = (k == 0) ? i
                : static_cast<int32_t>(n + e * n_int + (k - 1));
            int32_t b = (k == n_seg - 1) ? j
                : static_cast<int32_t>(n + e * n_int + k);
            new_conn[2 * (e * n_seg + k)] = a;
            new_conn[2 * (e * n_seg + k) + 1] = b;
            new_sect[e * n_seg + k] = sect[e];
        }
    }
    return 0;
}

// Greedy BFS aggregation of the node graph into connected aggregates of
// ~target_size (the coarse-space partition for the two-level PCG
// preconditioner, ops/coarse.py).  Bit-identical to the Python reference
// implementation: neighbor order is the stable src-sort of the half-edge
// list [edges forward; edges reversed], BFS frontier order is discovery
// order, and growth stops the moment count reaches target_size.
// edges: [ne, 2] int32 (one row per off-diagonal block / member).
// out_agg: [n_nodes] int64.  Returns the number of aggregates, or -1.
int64_t aggregate_nodes(const int32_t* edges, int64_t ne, int64_t n_nodes,
                        int64_t target_size, int64_t* out_agg) {
    if (n_nodes <= 0 || target_size <= 0) return -1;
    // adjacency in the Python half-edge order: all forward edges from u
    // (in edge order), then all reverse edges from u (in edge order)
    std::vector<int64_t> deg(n_nodes, 0);
    for (int64_t e = 0; e < ne; ++e) {
        ++deg[edges[2 * e]];
        ++deg[edges[2 * e + 1]];
    }
    std::vector<int64_t> ptr(n_nodes + 1, 0);
    for (int64_t v = 0; v < n_nodes; ++v) ptr[v + 1] = ptr[v] + deg[v];
    std::vector<int32_t> nbr(ptr[n_nodes]);
    std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
    for (int64_t e = 0; e < ne; ++e)           // forward pass first
        nbr[fill[edges[2 * e]]++] = edges[2 * e + 1];
    for (int64_t e = 0; e < ne; ++e)           // then the reversed pass
        nbr[fill[edges[2 * e + 1]]++] = edges[2 * e];

    std::vector<int64_t> agg(n_nodes, -1);
    std::vector<int32_t> frontier, nxt;
    int64_t next_agg = 0;
    for (int64_t seed = 0; seed < n_nodes; ++seed) {
        if (agg[seed] >= 0) continue;
        frontier.assign(1, static_cast<int32_t>(seed));
        agg[seed] = next_agg;
        int64_t count = 1;
        while (!frontier.empty() && count < target_size) {
            nxt.clear();
            for (int32_t u : frontier) {
                for (int64_t k = ptr[u]; k < ptr[u + 1]; ++k) {
                    int32_t v = nbr[k];
                    if (agg[v] < 0) {
                        agg[v] = next_agg;
                        nxt.push_back(v);
                        ++count;
                        if (count >= target_size) break;
                    }
                }
                if (count >= target_size) break;
            }
            frontier.swap(nxt);
        }
        ++next_agg;
    }
    for (int64_t v = 0; v < n_nodes; ++v) out_agg[v] = agg[v];
    return next_agg;
}


// Batched ASTM E1049 rainflow Miner sums for fatigue screening.
// y: [S, M] C-order float64 stress histories (column j = member j).
// For each member: reduce to turning points, run the rainflow stack
// (full cycles weight 1, the history-start and residual half cycles
// weight 0.5), and accumulate out_sum[j] = sum w * range^m_slope and
// out_n[j] = sum w.  One O(S) pass per member -- replaces a per-member
// Python loop that dominates long-history screens.
int rainflow_damage_sums(const double* y, int64_t S, int64_t M,
                         double m_slope, double* out_sum, double* out_n) {
    if (S < 2) {
        for (int64_t j = 0; j < M; ++j) { out_sum[j] = 0.0; out_n[j] = 0.0; }
        return 0;
    }
    std::vector<double> tp;
    std::vector<double> stack;
    for (int64_t j = 0; j < M; ++j) {
        tp.clear();
        tp.push_back(y[j]);
        for (int64_t i = 1; i + 1 < S; ++i) {
            const double a = y[(i - 1) * M + j];
            const double b = y[i * M + j];
            const double c = y[(i + 1) * M + j];
            if ((b - a) * (c - b) < 0.0) tp.push_back(b);
        }
        tp.push_back(y[(S - 1) * M + j]);
        stack.clear();
        double sum = 0.0, n = 0.0;
        for (double x : tp) {
            stack.push_back(x);
            while (stack.size() >= 3) {
                const size_t k = stack.size();
                const double X = std::fabs(stack[k - 2] - stack[k - 1]);
                const double Y = std::fabs(stack[k - 3] - stack[k - 2]);
                if (X < Y) break;
                if (k == 3) {
                    sum += 0.5 * std::pow(Y, m_slope);   // start half cycle
                    n += 0.5;
                    stack.erase(stack.begin());
                } else {
                    sum += std::pow(Y, m_slope);          // full cycle
                    n += 1.0;
                    stack.erase(stack.end() - 3, stack.end() - 1);
                }
            }
        }
        for (size_t i = 0; i + 1 < stack.size(); ++i) {   // residual halves
            sum += 0.5 * std::pow(std::fabs(stack[i] - stack[i + 1]), m_slope);
            n += 0.5;
        }
        out_sum[j] = sum;
        out_n[j] = n;
    }
    return 0;
}

}  // extern "C"
