"""Batched alpha-CNG neighbor selection.

Batched re-expression of select_neighbors_alpha_cng
(/root/reference/include/cphnsw/graph/neighbor_selection.hpp:21-88): the
per-node greedy scan over distance-sorted candidates is inherently
sequential (each admission depends on the already-selected set), so it runs
as a lax.fori_loop over the candidate axis — but vmapped over all N nodes at
once, with the candidate-pairwise distance matrix precomputed as one big
gathered matmul.

Semantics preserved:
  * dedup by id, sort by distance;
  * local_alpha = clamp(alpha * sqrt(n_cands / R), 1, alpha_max);
  * reject candidate c if exists selected e with
      d(c, e) < local_alpha * d(c, q) + err_c + err_e - (local_alpha-1)*tau;
  * backfill remaining slots with the nearest unselected candidates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cphnsw_tpu.graph.nndescent import FLOAT_MAX, INVALID, _dedup_sort_pairs


@functools.partial(jax.jit, static_argnames=("r",))
def select_alpha_cng(
    cand_ids: jax.Array,     # (N, C) candidate ids, -1 invalid, deduped or not
    cand_dists: jax.Array,   # (N, C) d(candidate, node)
    pair_dists: jax.Array,   # (N, C, C) d(candidate_i, candidate_j)
    cand_err: jax.Array,     # (N, C) per-candidate error margin err_c
    alpha: jax.Array,
    tau: jax.Array,
    alpha_max: jax.Array,
    r: int,
):
    """Returns (sel_ids (N, R), sel_dists (N, R)) — pruned + backfilled,
    distance-sorted.  pair_dists must be aligned with the given candidate
    order (callers sort candidates by (id, dist) -> dedup -> dist first and
    gather pair distances in that final order)."""
    n, c = cand_ids.shape
    valid = cand_ids >= 0
    n_valid = valid.sum(axis=1)

    local_alpha = alpha * jnp.sqrt(
        jnp.maximum(n_valid.astype(jnp.float32), 1.0) / float(r)
    )
    local_alpha = jnp.clip(local_alpha, 1.0, jnp.maximum(alpha_max, 1.0))

    # If n_valid <= R everything is kept (reference :42).
    keep_all = n_valid <= r

    def prune_one(ids, dists, pd, errs, la, keep_all_i):
        def body(i, state):
            selected, count = state
            d_cq = dists[i]
            err_c = errs[i]
            # threshold against every already-selected candidate
            thresholds = la * d_cq + err_c + errs - (la - 1.0) * tau
            conflict = selected & (pd[i] < thresholds)
            ok = (
                (ids[i] >= 0)
                & ~conflict.any()
                & (count < r)
            )
            selected = selected.at[i].set(ok)
            return selected, count + ok.astype(jnp.int32)

        selected0 = jnp.zeros((c,), dtype=bool)
        selected, _ = jax.lax.fori_loop(0, c, body, (selected0, jnp.int32(0)))
        selected = jnp.where(keep_all_i, ids >= 0, selected)
        return selected

    selected = jax.vmap(prune_one)(
        cand_ids, cand_dists, pair_dists, cand_err, local_alpha, keep_all
    )

    # Backfill: order by (selected desc, dist asc), take first R.
    sort_key = jnp.where(
        cand_ids < 0,
        FLOAT_MAX,
        jnp.where(selected, cand_dists, cand_dists + 1e18),
    )
    neg_top, order = jax.lax.top_k(-sort_key, r)
    sel_ids = jnp.take_along_axis(cand_ids, order, axis=1)
    sel_dists = jnp.take_along_axis(cand_dists, order, axis=1)
    sel_ids = jnp.where(-neg_top >= FLOAT_MAX, INVALID, sel_ids)
    sel_dists = jnp.where(sel_ids < 0, FLOAT_MAX, sel_dists)

    # Final presentation order: selected block is distance-sorted already;
    # backfilled entries carry +1e18 in the key so they follow, also sorted.
    return sel_ids, sel_dists


def candidate_pair_dists(
    raw: jax.Array, norm_sq: jax.Array, cand_ids: jax.Array
) -> jax.Array:
    """(N, C, C) pairwise distances among each node's candidates — one
    batched matmul over gathered vectors."""
    safe = jnp.maximum(cand_ids, 0)
    v = raw[safe]                        # (N, C, P)
    ns = norm_sq[safe]                   # (N, C)
    dots = jnp.einsum(
        "ncp,nmp->ncm", v, v, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    d = ns[:, :, None] + ns[:, None, :] - 2.0 * dots
    d = jnp.maximum(d, 0.0)
    invalid = (cand_ids < 0)[:, :, None] | (cand_ids < 0)[:, None, :]
    return jnp.where(invalid, FLOAT_MAX, d)


def prepare_candidates(cand_ids, cand_dists):
    """Dedup by id keeping the best distance, then distance-sort.

    Matches the reference's two-phase sort+unique+sort
    (neighbor_selection.hpp:31-40)."""
    ids_s, dists_s = _dedup_sort_pairs(cand_ids, cand_dists)
    dup = jnp.concatenate(
        [
            jnp.zeros_like(ids_s[:, :1], dtype=bool),
            (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0),
        ],
        axis=1,
    )
    ids_s = jnp.where(dup, INVALID, ids_s)
    dists_s = jnp.where(ids_s < 0, FLOAT_MAX, dists_s)
    order = jnp.argsort(dists_s, axis=1)
    return (
        jnp.take_along_axis(ids_s, order, axis=1),
        jnp.take_along_axis(dists_s, order, axis=1),
    )
