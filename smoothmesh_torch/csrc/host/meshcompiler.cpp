// The topology compiler's hot builds on the host, in O(M) (M = face
// perimeter entries): edge extraction by open-addressing hashing, and
// grouping into padded rows in input order.  The numpy path of
// smoothmesh_torch/mesh/topology.py pays O(M log M) sorts for the same
// tables.  Plain C interface, bound with ctypes by
// smoothmesh_torch/native.py, which builds this file at first use
// (g++ -O3 -march=native -shared -fPIC).
//
// Index arrays are int32: every entity id (points, faces, cells,
// edges, perimeter entries) fits 2^31 up to ~170M cells, and int32
// halves the set-up's peak memory.  Sizes and offsets stay int64.

#include <cstdint>
#include <vector>

extern "C" {

// Hash-based edge extraction from face perimeters.
//
// Inputs:
//   flat[M]      face point labels (concatenated perimeters)
//   offsets[F+1] face start offsets into flat
//   n_points     number of mesh points
// Outputs (caller-allocated):
//   edge_of_pair[M]  edge id for each perimeter entry (edge from
//                    flat[k] to the cyclic next point in its face)
//   edges_out[2*M]   unique edge endpoints (lo, hi) in order of first
//                    appearance; only the first 2*n_edges are written
// Returns: number of unique edges (<= M), or -1 on a label out of range.
int64_t build_edges(const int32_t* flat, const int64_t* offsets,
                    int64_t n_faces, int64_t n_points,
                    int32_t* edge_of_pair, int32_t* edges_out) {
    const int64_t m = offsets[n_faces];
    // open addressing, power-of-two capacity >= 2*m
    uint64_t cap = 1;
    while (cap < (uint64_t)(2 * m + 4)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int32_t> slot_edge(cap, -1);
    std::vector<uint64_t> slot_key(cap, ~0ull);

    int32_t n_edges = 0;
    for (int64_t f = 0; f < n_faces; ++f) {
        const int64_t beg = offsets[f];
        const int64_t end = offsets[f + 1];
        const int64_t n = end - beg;
        for (int64_t k = 0; k < n; ++k) {
            int32_t a = flat[beg + k];
            int32_t b = flat[beg + (k + 1 == n ? 0 : k + 1)];
            if (a < 0 || b < 0 || a >= n_points || b >= n_points) return -1;
            const int32_t lo = a < b ? a : b;
            const int32_t hi = a < b ? b : a;
            const uint64_t key = (uint64_t)lo * (uint64_t)n_points
                + (uint64_t)hi;
            // splitmix-style scramble
            uint64_t h = key;
            h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
            h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
            h ^= h >> 33;
            uint64_t s = h & mask;
            while (true) {
                if (slot_edge[s] < 0) {
                    slot_edge[s] = n_edges;
                    slot_key[s] = key;
                    edges_out[2 * (int64_t)n_edges] = lo;
                    edges_out[2 * (int64_t)n_edges + 1] = hi;
                    edge_of_pair[beg + k] = n_edges;
                    ++n_edges;
                    break;
                }
                if (slot_key[s] == key) {
                    edge_of_pair[beg + k] = slot_edge[s];
                    break;
                }
                s = (s + 1) & mask;
            }
        }
    }
    return n_edges;
}

// Grouped padding: given (key, value) pairs, compute group sizes.
// counts must be zero-initialized with length n_rows.
void group_counts(const int32_t* keys, int64_t m, int32_t* counts) {
    for (int64_t i = 0; i < m; ++i) counts[keys[i]] += 1;
}

// Fill padded (n_rows x width) arrays from (key, value) pairs in input
// order, so each row is left-packed.  cursor must be zero-initialized
// (n_rows); out pre-filled with the pad value; mask with 0.
void group_fill(const int32_t* keys, const int32_t* vals, int64_t m,
                int64_t width, int32_t* cursor, int32_t* out,
                uint8_t* mask) {
    for (int64_t i = 0; i < m; ++i) {
        const int64_t r = keys[i];
        const int64_t c = cursor[r]++;
        out[r * width + c] = vals[i];
        mask[r * width + c] = 1;
    }
}

// Deduplicating variant: skips (key, val) pairs already present in the
// row (linear probe over the row: row widths are small degrees).
void group_fill_dedup(const int32_t* keys, const int32_t* vals, int64_t m,
                      int64_t width, int32_t* cursor, int32_t* out,
                      uint8_t* mask) {
    for (int64_t i = 0; i < m; ++i) {
        const int64_t r = keys[i];
        const int32_t v = vals[i];
        const int64_t n = cursor[r];
        bool dup = false;
        for (int64_t c = 0; c < n; ++c) {
            if (out[r * width + c] == v) { dup = true; break; }
        }
        if (dup) continue;
        out[r * width + n] = v;
        mask[r * width + n] = 1;
        cursor[r] = n + 1;
    }
}

// For each (edge, cell slot): the slots of the edge's two faces that
// belong to that cell (the reference's findCellFacePair,
// src/smoothMesh.C:1042-1097, precompiled).  Inputs are padded
// row-major arrays; returns 0 on success, -1 if any valid (edge, cell)
// has != 2 adjacent faces (a mesh sanity violation).
int64_t edge_cell_face_pairs(
    const int32_t* edge_faces, const uint8_t* ef_mask,
    const int32_t* edge_cells, const uint8_t* ec_mask,
    const int32_t* owner, const int32_t* neighbour /* -1 if none */,
    int64_t n_edges, int64_t wc, int64_t wf,
    int32_t* f0, int32_t* f1) {
    for (int64_t e = 0; e < n_edges; ++e) {
        const int32_t* ef = edge_faces + e * wf;
        const uint8_t* em = ef_mask + e * wf;
        const int32_t* ec = edge_cells + e * wc;
        const uint8_t* cm = ec_mask + e * wc;
        for (int64_t u = 0; u < wc; ++u) {
            int32_t a = 0, b = 0;
            int64_t cnt = 0;
            if (cm[u]) {
                const int32_t cell = ec[u];
                for (int64_t w = 0; w < wf; ++w) {
                    if (!em[w]) continue;
                    const int32_t f = ef[w];
                    if (owner[f] == cell || neighbour[f] == cell) {
                        if (cnt == 0) a = (int32_t)w;
                        else if (cnt == 1) b = (int32_t)w;
                        ++cnt;
                    }
                }
                if (cnt != 2) return -1;
            }
            f0[e * wc + u] = a;
            f1[e * wc + u] = b;
        }
    }
    return 0;
}

}  // extern "C"
