/* Native host-side graph runtime ops for cphnsw_tpu.
 *
 * The accelerator owns every batched compute path; these are the inherently
 * sequential host-side graph algorithms that back finalize():
 *
 *   - bfs_order:     cache-locality BFS renumbering of the pruned graph
 *                    (replacement context: reference
 *                    rabitq_graph.hpp:204-278 does this in C++ too)
 *   - reverse_topk:  per-target capped reverse-edge lists ordered by
 *                    distance (reference graph_refinement.hpp:393-402
 *                    builds unbounded reverse vectors)
 *
 * Compiled on demand by cphnsw_tpu/utils/native.py (cc -O3 -shared);
 * the pure-numpy fallbacks remain authoritative for semantics.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* BFS from entry over a fixed-degree adjacency (ids: n x r, -1 = none).
 * Unvisited leftovers get appended in index order (disconnected comps).
 * out_old_to_new must hold n int64 entries. */
void bfs_order(const int32_t *ids, int64_t n, int64_t r, int64_t entry,
               int64_t *out_old_to_new) {
    unsigned char *visited = (unsigned char *)calloc((size_t)n, 1);
    int64_t *queue = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    int64_t head = 0, tail = 0, next_new = 0;

    if (entry >= 0 && entry < n) {
        queue[tail++] = entry;
        visited[entry] = 1;
    }
    for (int64_t seed = -1;;) {
        while (head < tail) {
            int64_t cur = queue[head++];
            out_old_to_new[cur] = next_new++;
            const int32_t *row = ids + cur * r;
            for (int64_t j = 0; j < r; ++j) {
                int32_t v = row[j];
                if (v >= 0 && v < n && !visited[v]) {
                    visited[v] = 1;
                    queue[tail++] = v;
                }
            }
        }
        /* find next unvisited component seed */
        int64_t s = seed + 1;
        while (s < n && visited[s]) ++s;
        if (s >= n) break;
        seed = s;
        visited[s] = 1;
        queue[tail++] = s;
    }
    free(queue);
    free(visited);
}

typedef struct {
    float d;
    int32_t src;
} RevEntry;

/* Reverse edges capped at r_rev per target, keeping the closest sources.
 * ids/dists: n x r forward lists.  out_ids/out_dists: n x r_rev
 * (pre-filled by caller with -1 / FLT_MAX).  Uses per-target binary-heap
 * of size r_rev (max-heap on distance). */
void reverse_topk(const int32_t *ids, const float *dists, int64_t n,
                  int64_t r, int64_t r_rev, int32_t *out_ids,
                  float *out_dists) {
    int32_t *counts = (int32_t *)calloc((size_t)n, sizeof(int32_t));
    RevEntry *heaps =
        (RevEntry *)malloc((size_t)n * (size_t)r_rev * sizeof(RevEntry));

    for (int64_t u = 0; u < n; ++u) {
        const int32_t *row = ids + u * r;
        const float *drow = dists + u * r;
        for (int64_t j = 0; j < r; ++j) {
            int32_t v = row[j];
            if (v < 0 || v >= n) continue;
            float d = drow[j];
            RevEntry *heap = heaps + (int64_t)v * r_rev;
            int32_t cnt = counts[v];
            if (cnt < r_rev) {
                /* push */
                int64_t i = cnt;
                heap[i].d = d;
                heap[i].src = (int32_t)u;
                while (i > 0) {
                    int64_t parent = (i - 1) / 2;
                    if (heap[parent].d < heap[i].d) {
                        RevEntry t = heap[parent];
                        heap[parent] = heap[i];
                        heap[i] = t;
                        i = parent;
                    } else {
                        break;
                    }
                }
                counts[v] = cnt + 1;
            } else if (d < heap[0].d) {
                /* replace root, sift down */
                heap[0].d = d;
                heap[0].src = (int32_t)u;
                int64_t i = 0;
                for (;;) {
                    int64_t l = 2 * i + 1, rr = 2 * i + 2, m = i;
                    if (l < r_rev && heap[l].d > heap[m].d) m = l;
                    if (rr < r_rev && heap[rr].d > heap[m].d) m = rr;
                    if (m == i) break;
                    RevEntry t = heap[m];
                    heap[m] = heap[i];
                    heap[i] = t;
                    i = m;
                }
            }
        }
    }

    for (int64_t v = 0; v < n; ++v) {
        RevEntry *heap = heaps + v * r_rev;
        int32_t cnt = counts[v];
        int32_t *oi = out_ids + v * r_rev;
        float *od = out_dists + v * r_rev;
        for (int32_t j = 0; j < cnt; ++j) {
            oi[j] = heap[j].src;
            od[j] = heap[j].d;
        }
    }
    free(heaps);
    free(counts);
}
