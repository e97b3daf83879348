"""HNSW upper layers: hierarchical entry-point selection.

Parity component for the reference's upper-layer machinery
(/root/reference/include/cphnsw/api/hnsw_index.hpp:484-716): exponential
level assignment (level = floor(-ln(U) * mL), mL = 1/ln(M_UPPER)), one
navigable graph per level, greedy descent from the top at query time.

Batched construction: instead of the reference's sequential per-node
insertion (greedy descent + ef-limited search + alpha-CNG per inserted
node, :566-613), each level's graph is built with the SAME batched
NNDescent + alpha-CNG machinery used for layer 0, over the level's node
subset, followed by the two properties the reference's insertion loop
provides implicitly and NNDescent does not:

  * bidirectional edges — a reverse-edge pass merges each node's
    incoming edges into its candidate set and re-prunes with alpha-CNG
    (the batched analog of the reference's bidirectional insert +
    prune_upper_neighbors, :601-607, :693-716);
  * navigability from the entry — undirected connected components are
    computed on the host and every minor component is bridged to the
    main one through its globally nearest cross-component pair (the
    insertion loop never creates disconnected upper graphs; NNDescent
    on clustered data can).

Functionally both produce a navigable proximity graph per level; ours is
one batched program per level instead of n_upper sequential searches.

Query-time greedy descent (:617-638) runs as a batched while_loop: one
iteration gathers every query's current neighbor list, exact-scores it with
a gathered matmul, and steps to the argmin until no query improves.

The default Index entry strategy remains the sampled-entry seed scan
(search/beam.py) — one dense matmul beats pointer-chasing descent on an
accelerator —
but the hierarchy is available via Index(entry_strategy="hnsw") for parity
and for datasets where it wins.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.graph import nndescent, pruning


def upper_layer_degree(r: int, padded_dim: int) -> int:
    """M_UPPER = R/2 + min(isqrt(P)/4, R/4)
    (core/adaptive_defaults.hpp:64-70)."""
    return r // 2 + min(math.isqrt(padded_dim) // 4, r // 4)


MIN_LAYER_RANDOM = 1e-15  # constants.hpp:26


def assign_levels(n: int, m_upper: int, seed: int = 42) -> np.ndarray:
    """Exponentially decaying level assignment (hnsw_index.hpp:484-503)."""
    ml = 1.0 / math.log(max(m_upper, 2))
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.uniform(size=n), MIN_LAYER_RANDOM)
    return np.floor(-np.log(u) * ml).astype(np.int32)


class UpperLayers(NamedTuple):
    """Per-level subset graphs, all padded to the same tuple structure."""

    node_ids: tuple          # per level: (n_l,) int32 global ids
    nbr_idx: tuple           # per level: (n_l, M) int32 local indices, -1
    local_of_global: tuple   # per level: (n,) int32 local index or -1
    entry_global: int        # global id of the single top-level entry


def _bridge_components(sub_raw, sub_norm, sel, entry_local: int) -> jax.Array:
    """Make every node of the level graph reachable from the level entry
    by DIRECTED out-edges (what query-time greedy descent actually
    follows), bridging unreached regions through their nearest cross
    pair in both directions.

    The reference's insertion build cannot produce disconnected upper
    graphs (every insert links to already-reachable nodes,
    hnsw_index.hpp:566-613); NNDescent on well-separated clusters can —
    and an unreachable region silently strands greedy descent.
    Undirected connectivity is NOT enough: a component linked only by
    minor->main edges counts as connected yet stays unreachable from the
    entry, so reachability is computed as directed BFS from entry_local.
    Bridge edges go into the first free (-1) slot, else rotate through
    the worst slots so multiple bridges into one node never overwrite
    each other.
    """
    sel_np = np.array(sel)  # writable host copy
    n_l, deg = sel_np.shape
    raw_h = np.asarray(sub_raw)
    norm_h = np.asarray(sub_norm)
    bridged = np.zeros(n_l, np.int64)  # bridges already placed per node

    def place(a: int, b: int):
        row = sel_np[a]
        if (row == b).any():
            return
        free = np.where(row < 0)[0]
        if free.size:
            row[free[0]] = b
        else:
            row[deg - 1 - (bridged[a] % deg)] = b
        bridged[a] += 1

    for _ in range(n_l):  # each pass strictly shrinks the unreached set
        reached = np.zeros(n_l, bool)
        reached[entry_local] = True
        frontier = np.array([entry_local])
        while frontier.size:
            out = sel_np[frontier].ravel()
            out = out[out >= 0]
            nxt = np.unique(out)
            nxt = nxt[~reached[nxt]]
            reached[nxt] = True
            frontier = nxt
        if reached.all():
            break
        # weakly-connected components of the unreached subgraph, each
        # bridged to the reached set through its nearest cross pair
        comp = np.full(n_l, -1, np.int64)
        n_comp = 0
        for start in np.where(~reached)[0]:
            if comp[start] >= 0:
                continue
            comp[start] = n_comp
            frontier = np.array([start])
            while frontier.size:
                out = sel_np[frontier].ravel()
                out = out[out >= 0]
                out = out[~reached[out]]
                inc = np.where(
                    ~reached & np.isin(sel_np, frontier).any(axis=1)
                )[0]
                nxt = np.unique(np.concatenate([out, inc]))
                nxt = nxt[comp[nxt] < 0]
                comp[nxt] = n_comp
                frontier = nxt
            n_comp += 1
        r_idx = np.where(reached)[0]
        for c in range(n_comp):
            idx = np.where(comp == c)[0]
            d = (
                norm_h[idx][:, None]
                + norm_h[r_idx][None, :]
                - 2.0 * raw_h[idx] @ raw_h[r_idx].T
            )
            i, j = np.unravel_index(np.argmin(d), d.shape)
            a, b = int(idx[i]), int(r_idx[j])
            place(b, a)  # reached -> unreached: makes the region reachable
            place(a, b)  # back edge keeps descent able to leave again
    else:
        # budget exhausted with nodes possibly still unreachable (slot
        # rotation can disconnect an earlier bridge): force direct
        # entry -> node edges (up to the entry row's degree) rather than
        # returning a layer that strands greedy descent — the exact
        # failure this function exists to prevent
        import warnings

        for _ in range(deg):
            reached = np.zeros(n_l, bool)
            reached[entry_local] = True
            frontier = np.array([entry_local])
            while frontier.size:
                out = sel_np[frontier].ravel()
                out = out[out >= 0]
                nxt = np.unique(out)
                nxt = nxt[~reached[nxt]]
                reached[nxt] = True
                frontier = nxt
            missing = np.where(~reached)[0]
            if missing.size == 0:
                break
            place(entry_local, int(missing[0]))
        else:
            warnings.warn(
                "upper-layer bridging exhausted its budget with nodes "
                "still unreachable from the entry; descent may start "
                "suboptimally on this layer", RuntimeWarning,
            )
    return jnp.asarray(sel_np)


def build_upper_layers(
    raw: jax.Array,
    norm_sq: jax.Array,
    r: int,
    seed: int = 42,
) -> UpperLayers | None:
    """Build the hierarchy; returns None when no node reaches level 1."""
    n, p = raw.shape
    m_up = upper_layer_degree(r, p)
    levels = assign_levels(n, m_up, seed)
    max_level = int(levels.max()) if n else 0
    if max_level == 0:
        return None

    # the query-time entry (first node of the highest built level) is
    # known up front: levels are assigned before any graph is built, and
    # a level only builds while it has >= 2 nodes — bridging at every
    # level targets directed reachability from THIS node.
    top_lvl = max(
        (l for l in range(1, max_level + 1) if (levels >= l).sum() >= 2),
        default=0,
    )
    if top_lvl == 0:
        return None
    entry_global = int(np.where(levels >= top_lvl)[0][0])

    node_ids, nbr_idx, local_maps = [], [], []
    for lvl in range(1, max_level + 1):
        subset = np.where(levels >= lvl)[0].astype(np.int32)
        n_l = len(subset)
        if n_l < 2:
            break
        sub_raw = raw[jnp.asarray(subset)]
        sub_norm = norm_sq[jnp.asarray(subset)]
        deg = min(m_up, n_l - 1)
        if n_l <= deg + 1:
            # tiny level: fully connected
            ids = np.tile(np.arange(n_l, dtype=np.int32), (n_l, 1))
            mask = ids != np.arange(n_l, dtype=np.int32)[:, None]
            full = np.full((n_l, deg), -1, np.int32)
            for i in range(n_l):
                others = ids[i][mask[i]][:deg]
                full[i, : len(others)] = others
            sel = jnp.asarray(full)
        else:
            from cphnsw_tpu.graph import build as gbuild

            wg = nndescent.run_adaptive(
                sub_raw, sub_norm, deg, seed=seed + 100 + lvl
            )

            def _prune(ids, dists):
                ci, cd = pruning.prepare_candidates(ids, dists)
                pd = pruning.candidate_pair_dists(sub_raw, sub_norm, ci)
                return pruning.select_alpha_cng(
                    ci, cd, pd, jnp.zeros_like(cd),
                    jnp.float32(1.2), jnp.float32(0.0), jnp.float32(2.4),
                    deg,
                )

            sel, sel_d = _prune(wg.ids, wg.dists)
            # bidirectional pass: merge reverse edges, re-prune
            rev_i, rev_d = gbuild._reverse_candidates(sel, sel_d, 2 * deg)
            sel, sel_d = _prune(
                jnp.concatenate([sel, rev_i], axis=1),
                jnp.concatenate([sel_d, rev_d], axis=1),
            )
            entry_local = int(np.searchsorted(subset, entry_global))
            sel = _bridge_components(sub_raw, sub_norm, sel, entry_local)
        lm = np.full(n, -1, np.int32)
        lm[subset] = np.arange(n_l, dtype=np.int32)
        node_ids.append(jnp.asarray(subset))
        nbr_idx.append(sel)
        local_maps.append(jnp.asarray(lm))

    if not node_ids:
        return None
    # entry_global == first node of the highest built level by
    # construction (node_ids[-1][0])
    return UpperLayers(
        node_ids=tuple(node_ids),
        nbr_idx=tuple(nbr_idx),
        local_of_global=tuple(local_maps),
        entry_global=entry_global,
    )


@functools.partial(jax.jit, static_argnames=("max_iters", "ef"))
def greedy_descend(
    upper: UpperLayers,
    raw: jax.Array,
    norm_sq: jax.Array,
    qpad: jax.Array,
    qnorm: jax.Array,
    max_iters: int = 32,
    ef: int = 8,
):
    """Beam descent through all levels; returns (Q, ef) global entry ids
    for layer 0 (hnsw_index.hpp:197-201 + :617-638), batched over queries.

    ef > 1 carries the ef best nodes per level instead of a single greedy
    walker (each step expands every carried node's neighbor list with one
    gathered matmul and keeps the top-ef of the union).  The reference
    descends with ef=1 at query time; on well-separated clusters a single
    walker strands in the entry's cluster (the reference measures ~0.43
    recall on such data) — a tiny beam costs one extra gather per level
    and repairs that failure mode, so the divergence is deliberate.
    """
    q = qpad.shape[0]
    cur_global = jnp.full((q, 1), upper.entry_global, jnp.int32)
    cur_d = (
        qnorm[:, None]
        + norm_sq[cur_global]
        - 2.0
        * jnp.einsum("qp,qep->qe", qpad, raw[cur_global],
                     precision=jax.lax.Precision.HIGHEST)
    )

    for lvl in range(len(upper.node_ids) - 1, -1, -1):
        ids_l = upper.node_ids[lvl]
        nbrs_l = upper.nbr_idx[lvl]
        lm = upper.local_of_global[lvl]
        e = cur_global.shape[1]

        cur_local = lm[cur_global]          # guaranteed present (nested)

        def body(state):
            cur_local, cur_d, improved, it = state
            nb = nbrs_l[cur_local]                       # (Q, e, M) local
            nb = nb.reshape(q, -1)
            nb_safe = jnp.maximum(nb, 0)
            nb_global = ids_l[nb_safe]
            d = (
                qnorm[:, None]
                + norm_sq[nb_global]
                - 2.0
                * jnp.einsum("qp,qmp->qm", qpad, raw[nb_global],
                             precision=jax.lax.Precision.HIGHEST)
            )
            d = jnp.where(nb < 0, jnp.inf, d)
            # dedup within the union (keep first occurrence)
            cat_l = jnp.concatenate([cur_local, nb_safe], axis=1)
            cat_d = jnp.concatenate([cur_d, d], axis=1)
            same = cat_l[:, :, None] == cat_l[:, None, :]
            earlier = (
                jnp.arange(cat_l.shape[1])[None, :, None]
                > jnp.arange(cat_l.shape[1])[None, None, :]
            )
            dup = (same & earlier).any(-1)
            cat_d = jnp.where(dup, jnp.inf, cat_d)
            neg_top, sel = jax.lax.top_k(-cat_d, cur_local.shape[1])
            new_local = jnp.take_along_axis(cat_l, sel, axis=1)
            new_d = -neg_top
            better = new_d[:, 0] < cur_d[:, 0]
            return new_local, new_d, better.any(), it + 1

        def cond(state):
            _, _, improved, it = state
            return improved & (it < max_iters)

        # widen the carried beam to ef once the level is large enough
        width = min(ef, int(ids_l.shape[0]))
        if e < width:
            pad = width - e
            cur_local = jnp.concatenate(
                [cur_local, jnp.repeat(cur_local[:, :1], pad, axis=1)],
                axis=1,
            )
            cur_d = jnp.concatenate(
                [cur_d, jnp.full((q, pad), jnp.inf)], axis=1
            )
        cur_local, cur_d, _, _ = jax.lax.while_loop(
            cond, body, (cur_local, cur_d, jnp.bool_(True), jnp.int32(0))
        )
        cur_global = ids_l[cur_local]

    # slots never filled with a real node (beam wider than the reachable
    # set: inf-priced pads and in-beam duplicates) become -1 so
    # beam.search_batch treats them as empty instead of duplicating ids
    # in its initial result heap
    return jnp.where(jnp.isinf(cur_d), -1, cur_global)
