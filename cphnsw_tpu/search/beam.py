"""Batched DABS beam search: batch-of-queries frontier traversal.

Accelerator re-expression of rabitq_search::search
(/root/reference/include/cphnsw/search/rabitq_search.hpp:60-277).  The
pointer-chasing priority-queue loop becomes one lax.while_loop over the
whole query batch: every iteration pops one beam entry per query (masked by
per-query done flags), gathers that node's neighbor block, runs the matmul
fastscan + distance conversion for all Q*R edges at once, exact-reranks the
survivors with a gathered matmul, and merges results/beam with top-k ops.

Semantics preserved per query (all masked, lockstep):
  * DABS termination: stop when best beam estimate >= gamma_q * d_k
    (:120) and the result heap is full;
  * lower-bound expansion skip (:122);
  * per-expansion slack-level escalation: dot_slack walks down the
    precomputed EVT ladder (:141-145);
  * warmup phase until k results: every unseen neighbor is exact-scored
    and enqueued un-gated (:210, :234-242);
  * candidate gates: lower-bound skip (:246), est < d_k -> exact rerank +
    result push (:248-250), est < gamma_q*d_k -> enqueue (:229-232, :269);
  * online gamma_q adaptation from est/exact ratio variance (:255-267);
  * visited dedup via a per-query device-resident mask, replacing the
    epoch-stamped TwoLevelVisitationTable (visitation_table.hpp:49-108) —
    per-query state makes the epoch trick unnecessary.

The N-bit two-stage MSB path computes the MSB lower bound from planes 0-1
and the full-precision estimate from all planes in the same pass (on an
accelerator compute-both-and-select is cheaper than the data-dependent branch,
SURVEY.md section 7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cphnsw_tpu.graph.build import NeighborStore
from cphnsw_tpu.ops import estimate, hadamard, pack, quantize

FLOAT_MAX = jnp.float32(jnp.finfo(jnp.float32).max)
EPS_SMALL = 1e-12


class SearchParams(NamedTuple):
    """Calibration-derived search constants (CalibrationSnapshot subset,
    api/hnsw_index.hpp:32-58).  All scalars except slack_levels."""

    affine_a: jax.Array
    affine_b: jax.Array
    ip_qo_floor: jax.Array
    slack_levels: jax.Array   # (L,) ip-space slack ladder
    gamma: jax.Array          # search_gamma (baseline)
    gamma_max: jax.Array
    gamma_beta: jax.Array
    gamma_warmup: jax.Array   # int32

    @classmethod
    def default(cls, num_levels: int = 4):
        return cls(
            affine_a=jnp.float32(1.0),
            affine_b=jnp.float32(0.0),
            ip_qo_floor=jnp.float32(0.0),
            slack_levels=jnp.zeros(num_levels, jnp.float32),
            gamma=jnp.float32(1.0),
            gamma_max=jnp.float32(1.5),
            gamma_beta=jnp.float32(0.0),
            gamma_warmup=jnp.int32(1 << 30),
        )


class BeamState(NamedTuple):
    beam_ids: jax.Array    # (Q, B) int32
    beam_est: jax.Array    # (Q, B) f32, FLOAT_MAX = empty
    beam_lower: jax.Array  # (Q, B)
    res_ids: jax.Array     # (Q, K) int32, sorted by distance
    res_d: jax.Array       # (Q, K) f32, FLOAT_MAX = empty
    visited: jax.Array     # (Q, N+1) bool; column N is a scatter trash slot
    gamma_q: jax.Array     # (Q,)
    ratio_sum: jax.Array
    ratio_sq: jax.Array
    ratio_cnt: jax.Array   # (Q,) int32
    slack_cnt: jax.Array   # (Q,) int32
    done: jax.Array        # (Q,)
    steps: jax.Array       # ()
    last_improve: jax.Array  # (Q,) int32: step of last result-set change
    res_step: jax.Array    # (Q, K) int32: step each result entry was pushed
    #   (last_improve/res_step drive the build-time step-budget
    #    derivation, api/index.py: budget for a k'-NN search = quantile of
    #    max(res_step[:, :k']) — the first step at which the final top-k'
    #    was already present)


def _merge_results(res_ids, res_d, res_step, cand_ids, cand_d, step, k: int):
    ids = jnp.concatenate([res_ids, cand_ids], axis=1)
    d = jnp.concatenate([res_d, cand_d], axis=1)
    steps = jnp.concatenate(
        [res_step, jnp.broadcast_to(step, cand_ids.shape)], axis=1
    )
    neg_top, sel = jax.lax.top_k(-d, k)
    return (
        jnp.take_along_axis(ids, sel, axis=1),
        -neg_top,
        jnp.take_along_axis(steps, sel, axis=1),
    )


@functools.partial(
    jax.jit,
    static_argnames=("bits", "k", "beam_cap", "max_steps", "n_seeds", "expand_width", "rerank_width", "visited_hash_bits", "debug_state"),
)
def search_batch(
    raw: jax.Array,
    norm_sq: jax.Array,
    neighbors: NeighborStore,
    entry_candidates: jax.Array,
    signs: jax.Array,
    queries: jax.Array,
    params: SearchParams,
    bits: int,
    k: int,
    beam_cap: int = 128,
    max_steps: int = 512,
    n_seeds: int = 4,
    expand_width: int = 1,
    rerank_width: int = 0,
    visited_hash_bits: int = 0,
    debug_state: bool = False,
):
    """DABS layer-0 search for a batch of queries.

    Returns (ids (Q, k) int32, dists (Q, k) f32 exact squared L2, sorted).

    entry_candidates: (M,) node ids — the hub entry plus a fixed sample of
    the dataset.  Each query exact-scores all M candidates with ONE matmul
    and seeds its beam with the n_seeds nearest.  This is the batch-idiomatic
    replacement for the reference's hierarchical greedy descent (SURVEY.md
    section 7 "Option B": hub entry + sampled entry beam): a coarse O(M)
    scan lands every query in its own region — and keeps recall on
    multi-component graphs where NNDescent + alpha-CNG leave clusters
    disconnected (the reference relies on its upper layers for this).
    """
    n, p = raw.shape
    q = queries.shape[0]
    r = neighbors.ids.shape[1]
    k_scale = float((1 << bits) - 1)
    msb_scale = 1.0 if bits < 2 else 3.0
    num_levels = params.slack_levels.shape[0]

    qpad = hadamard.pad_to(queries.astype(jnp.float32), p)
    qc = quantize.encode_queries(qpad, signs)
    qnorm = jnp.sum(qpad * qpad, axis=-1)
    q_idx = jnp.arange(q)

    # --- seed selection ---
    cands = jnp.asarray(entry_candidates, jnp.int32)
    if cands.ndim == 2:
        # per-query entry seeds (e.g. from HNSW upper-layer greedy descent)
        n_seeds = min(int(cands.shape[1]), beam_cap, k)
        seeds = cands[:, :n_seeds]
        # id < 0 marks an empty seed slot (greedy_descend pads short
        # beams with -1): price it FLOAT_MAX so it never reaches the
        # result heap, and keep the -1 id so downstream treats the slot
        # as empty.
        seeds_safe = jnp.maximum(seeds, 0)
        seed_d = estimate.exact_l2_sq(
            qpad, qnorm, raw[seeds_safe], norm_sq[seeds_safe]
        )
        seed_d = jnp.where(seeds >= 0, seed_d, FLOAT_MAX)
        order = jnp.argsort(seed_d, axis=1)
        seeds = jnp.take_along_axis(seeds, order, axis=1)
        seed_d = jnp.take_along_axis(seed_d, order, axis=1)
        seeds = jnp.where(seed_d < FLOAT_MAX, seeds, -1)
    else:
        # seed scan: exact distances to the shared candidate pool, top-S
        cands = cands.reshape(-1)
        n_seeds = min(n_seeds, int(cands.shape[0]), beam_cap, k)
        cand_dots = jnp.dot(
            qpad, raw[cands].T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d_cand = jnp.maximum(
            qnorm[:, None] + norm_sq[cands][None, :] - 2.0 * cand_dots, 0.0
        )  # (Q, M)
        neg_seed_d, seed_slot = jax.lax.top_k(-d_cand, n_seeds)
        seeds = cands[seed_slot]                       # (Q, S)
        seed_d = -neg_seed_d

    beam_ids = jnp.full((q, beam_cap), -1, jnp.int32).at[:, :n_seeds].set(
        seeds
    )
    beam_est = jnp.full((q, beam_cap), FLOAT_MAX).at[:, :n_seeds].set(seed_d)
    beam_lower = jnp.zeros((q, beam_cap))
    res_ids = jnp.full((q, k), -1, jnp.int32).at[:, :n_seeds].set(seeds)
    res_d = jnp.full((q, k), FLOAT_MAX).at[:, :n_seeds].set(seed_d)
    # Visited dedup structure: dense per-query bitmap (exact), or a
    # CAGRA-style per-query open-addressing hash table (visited_hash_bits
    # > 0): O(2^bits) memory instead of O(N) per query — essential at
    # million scale where the dense mask alone is N bytes/query and its
    # per-step update dominates the step cost.  Hash evictions only cost
    # occasional duplicate expansions; result exactness is preserved by
    # the explicit result-heap dedup below.
    # empty (-1) seed slots route to the spare visited slot (hash: the
    # extra h_size cell; dense: the extra n cell)
    if visited_hash_bits > 0:
        h_size = 1 << visited_hash_bits
        seed_slots = jnp.where(seeds >= 0, seeds % h_size, h_size)
        visited = (
            jnp.full((q, h_size + 1), -1, jnp.int32)
            .at[q_idx[:, None], seed_slots]
            .set(seeds)
        )
    else:
        visited = (
            jnp.zeros((q, n + 1), dtype=bool)
            .at[q_idx[:, None], jnp.where(seeds >= 0, seeds, n)]
            .set(True)
        )

    state = BeamState(
        beam_ids=beam_ids,
        beam_est=beam_est,
        beam_lower=beam_lower,
        res_ids=res_ids,
        res_d=res_d,
        visited=visited,
        gamma_q=jnp.broadcast_to(params.gamma, (q,)),
        ratio_sum=jnp.zeros(q),
        ratio_sq=jnp.zeros(q),
        ratio_cnt=jnp.zeros(q, jnp.int32),
        slack_cnt=jnp.zeros(q, jnp.int32),
        done=jnp.zeros(q, dtype=bool),
        steps=jnp.int32(0),
        last_improve=jnp.zeros(q, jnp.int32),
        res_step=jnp.zeros((q, k), jnp.int32),
    )

    def cond(s: BeamState):
        return (~s.done).any() & (s.steps < max_steps)

    def body(s: BeamState) -> BeamState:
        # ---- pop the best E beam entries per query ----
        neg_pop, pop_slots = jax.lax.top_k(-s.beam_est, expand_width)
        pop_est = -neg_pop                                     # (Q, E) asc
        pop_lower = jnp.take_along_axis(s.beam_lower, pop_slots, 1)
        pop_ids = jnp.take_along_axis(s.beam_ids, pop_slots, 1)
        pop_valid = pop_est < FLOAT_MAX

        best_est = pop_est[:, 0]
        empty = ~pop_valid[:, 0]
        d_k = s.res_d[:, k - 1]
        res_full = d_k < FLOAT_MAX
        terminate = res_full & (best_est >= s.gamma_q * d_k)
        done = s.done | empty | terminate
        active = ~done

        # remove the popped slots (for every still-active query)
        popped_mask = jnp.zeros_like(s.beam_est, dtype=bool).at[
            q_idx[:, None], pop_slots
        ].set(pop_valid)
        beam_est = jnp.where(
            active[:, None] & popped_mask, FLOAT_MAX, s.beam_est
        )

        # per-entry lower-bound expansion skip (:122)
        skip = res_full[:, None] & (pop_lower > d_k[:, None])
        expand_e = active[:, None] & pop_valid & ~skip          # (Q, E)
        expand = expand_e.any(1)
        cur_safe = jnp.where(expand_e, pop_ids, 0)              # (Q, E)

        # ---- exact distance to each popped node = d_qp^2 ----
        d_qp_sq = estimate.exact_l2_sq(
            qpad, qnorm, raw[cur_safe], norm_sq[cur_safe]
        )                                                      # (Q, E)

        # ---- slack-level escalation (:141-145) ----
        level = jnp.minimum(s.slack_cnt, num_levels - 1)
        dot_slack = params.slack_levels[level]
        slack_cnt = s.slack_cnt + expand_e.sum(1).astype(jnp.int32)

        # ---- score all E*R candidates per query ----
        er = expand_width * r
        g = neighbors.fused[cur_safe]                      # (Q, E, F)
        nbr_ids = g[..., :r].reshape(q, er)
        valid = (nbr_ids >= 0) & jnp.repeat(expand_e, r, axis=1)
        nbr_safe = jnp.where(valid, nbr_ids, 0)
        aux_g = jnp.stack(
            [
                jax.lax.bitcast_convert_type(
                    g[..., (1 + c) * r : (2 + c) * r], jnp.float32
                ).reshape(q, er)
                for c in range(4)
            ],
            axis=-1,
        )
        planes_wm = jax.lax.bitcast_convert_type(
            g[..., 5 * r : (5 + bits * neighbors.words) * r], jnp.uint32
        ).reshape(q, expand_width, bits, neighbors.words, r)
        planes = jnp.moveaxis(planes_wm, 4, 2)     # (Q,E,R,B,W)
        u = pack.unpack_planes(planes, p).reshape(q, er, p)
        fs = jnp.einsum(
            "qrp,qp->qr", u, qc.q_u, preferred_element_type=jnp.int32
        )
        ip_full = estimate.ip_from_fastscan(
            fs, aux_g[..., 3],
            qc.coeff_a[:, None], qc.coeff_b[:, None], qc.coeff_c[:, None],
            k_scale,
        )
        if bits >= 2:
            u_msb = pack.unpack_msb(planes, p, bits).reshape(q, er, p)
            fs_msb = jnp.einsum(
                "qrp,qp->qr", u_msb, qc.q_u,
                preferred_element_type=jnp.int32,
            )
            wpc_msb = u_msb.sum(-1)
            ip_bound = estimate.ip_from_fastscan(
                fs_msb, wpc_msb,
                qc.coeff_a[:, None], qc.coeff_b[:, None],
                qc.coeff_c[:, None], msb_scale,
            )
        else:
            ip_bound = ip_full

        calib = estimate.CalibParams(
            affine_a=params.affine_a,
            affine_b=params.affine_b,
            ip_qo_floor=params.ip_qo_floor,
            dot_slack=dot_slack[:, None],
        )
        d_qp_flat = jnp.repeat(d_qp_sq, r, axis=1)         # (Q, E*R)
        est, lower = estimate.distances_with_bounds(
            ip_full, ip_bound,
            aux_g[..., 0], aux_g[..., 1], aux_g[..., 2],
            d_qp_flat, calib,
        )

        # ---- dedup + gates ----
        if visited_hash_bits > 0:
            h_size = 1 << visited_hash_bits
            slot = nbr_safe % h_size
            seen = s.visited[q_idx[:, None], slot] == nbr_safe
        else:
            seen = s.visited[q_idx[:, None], nbr_safe]
        # intra-step dedup: two popped nodes may share a neighbor — keep
        # only the first occurrence within the flattened candidate row
        same = nbr_ids[:, :, None] == nbr_ids[:, None, :]
        earlier = (
            jnp.arange(er)[None, :, None] > jnp.arange(er)[None, None, :]
        )
        dup_prior = (same & earlier & valid[:, None, :]).any(-1)
        cand_ok = valid & ~seen & ~dup_prior
        if visited_hash_bits > 0:
            mark_slot = jnp.where(cand_ok, nbr_safe % h_size, h_size)
            visited = s.visited.at[q_idx[:, None], mark_slot].set(
                jnp.where(cand_ok, nbr_safe, -1), mode="drop"
            )
        else:
            mark_idx = jnp.where(cand_ok, nbr_safe, n)   # n = trash column
            visited = s.visited.at[q_idx[:, None], mark_idx].set(True)

        warmup = ~res_full
        pass_lower = warmup[:, None] | (lower < d_k[:, None])   # :246
        cand_ok = cand_ok & pass_lower

        rerank = cand_ok & (warmup[:, None] | (est < d_k[:, None]))  # :248

        # ---- capped exact rerank: only the rerank_width best estimates
        # fetch raw vectors (the bandwidth-dominant gather); the rest keep
        # their estimates and get exact-scored if later popped ----
        rw = min(rerank_width, er) if rerank_width > 0 else er
        if rw == er:
            # rerank everything: no selection sort needed
            rr_slots = jnp.broadcast_to(jnp.arange(er)[None, :], (q, er))
            rr_ok = rerank
            rr_node = nbr_safe
        else:
            rr_score = jnp.where(rerank, est, FLOAT_MAX)
            _, rr_slots = jax.lax.top_k(-rr_score, rw)         # (Q, rw)
            rr_ok = jnp.take_along_axis(rerank, rr_slots, 1)
            rr_node = jnp.take_along_axis(nbr_safe, rr_slots, 1)
        exact_rr = estimate.exact_l2_sq(
            qpad, qnorm, raw[rr_node], jnp.sum(
                raw[rr_node] * raw[rr_node], axis=-1
            )
        )

        # ---- result heap pushes: reranked candidates + popped nodes ----
        # (popped nodes push their own exact distance, reference :132-133;
        # dedup against existing results since a node may have been pushed
        # at its rerank step already)
        pop_in_res = (
            (pop_ids[:, :, None] == s.res_ids[:, None, :])
            & (pop_ids >= 0)[:, :, None]
        ).any(-1)
        pop_push_ok = expand_e & ~pop_in_res
        rr_in_res = (
            (rr_node[:, :, None] == s.res_ids[:, None, :]) & rr_ok[:, :, None]
        ).any(-1)
        push_ids = jnp.concatenate([rr_node, cur_safe], axis=1)
        push_d = jnp.concatenate(
            [
                jnp.where(rr_ok & ~rr_in_res, exact_rr, FLOAT_MAX),
                jnp.where(pop_push_ok, d_qp_sq, FLOAT_MAX),
            ],
            axis=1,
        )
        res_ids_new, res_d_new, res_step_new = _merge_results(
            s.res_ids, s.res_d, s.res_step, push_ids, push_d, s.steps + 1, k
        )
        res_ids = jnp.where(expand[:, None], res_ids_new, s.res_ids)
        res_d = jnp.where(expand[:, None], res_d_new, s.res_d)
        res_step = jnp.where(expand[:, None], res_step_new, s.res_step)
        improved = expand & (res_d != s.res_d).any(1)
        last_improve = jnp.where(
            improved & active, s.steps + 1, s.last_improve
        )

        # ---- DABS enqueue gate (:229-232, :248-271) ----
        d_k_new = res_d[:, k - 1]
        res_full_new = d_k_new < FLOAT_MAX
        dabs_thresh = jnp.where(
            res_full_new, s.gamma_q * d_k_new, FLOAT_MAX
        )[:, None]
        # reranked entries carry exact distances as beam priority
        enq_val = est.at[q_idx[:, None], rr_slots].set(
            jnp.where(rr_ok, exact_rr, jnp.take_along_axis(est, rr_slots, 1))
        )
        enq_lower = jnp.where(warmup[:, None], enq_val, lower)
        enq = cand_ok & (enq_val < dabs_thresh)

        cand_est = jnp.where(enq, enq_val, FLOAT_MAX)
        all_est = jnp.concatenate([beam_est, cand_est], axis=1)
        all_ids = jnp.concatenate([s.beam_ids, nbr_ids], axis=1)
        all_lower = jnp.concatenate([s.beam_lower, enq_lower], axis=1)
        # approx_max_k: the beam is a heuristic frontier — approximate
        # selection replaces the full bitonic sort that
        # dominates the per-step cost (exactness is only needed in the
        # result heap, which uses exact top_k)
        neg_top, slot = jax.lax.approx_max_k(
            -all_est, beam_cap, recall_target=0.95
        )
        beam_est_new = -neg_top
        beam_ids_new = jnp.take_along_axis(all_ids, slot, axis=1)
        beam_lower_new = jnp.take_along_axis(all_lower, slot, axis=1)

        beam_est = jnp.where(active[:, None], beam_est_new, s.beam_est)
        beam_ids = jnp.where(active[:, None], beam_ids_new, s.beam_ids)
        beam_lower = jnp.where(active[:, None], beam_lower_new, s.beam_lower)

        # ---- online gamma_q adaptation (:255-267) ----
        est_rr = jnp.take_along_axis(est, rr_slots, 1)
        contrib = rr_ok & ~warmup[:, None] & (exact_rr > EPS_SMALL)
        ratio = jnp.where(
            contrib, est_rr / jnp.maximum(exact_rr, EPS_SMALL), 0.0
        )
        ratio_sum = s.ratio_sum + jnp.where(expand, ratio.sum(1), 0.0)
        ratio_sq = s.ratio_sq + jnp.where(expand, (ratio * ratio).sum(1), 0.0)
        ratio_cnt = s.ratio_cnt + jnp.where(
            expand, contrib.sum(1), 0
        ).astype(jnp.int32)
        cnt_f = jnp.maximum(ratio_cnt.astype(jnp.float32), 1.0)
        r_mean = ratio_sum / cnt_f
        r_var = jnp.maximum(ratio_sq / cnt_f - r_mean * r_mean, 0.0)
        r_std = jnp.sqrt(r_var)
        gamma_new = jnp.clip(
            params.gamma * (1.0 + params.gamma_beta * r_std),
            params.gamma,
            params.gamma_max,
        )
        gamma_q = jnp.where(
            expand & (ratio_cnt >= params.gamma_warmup), gamma_new, s.gamma_q
        )

        return BeamState(
            beam_ids=beam_ids,
            beam_est=beam_est,
            beam_lower=beam_lower,
            res_ids=res_ids,
            res_d=res_d,
            visited=visited,
            gamma_q=gamma_q,
            ratio_sum=ratio_sum,
            ratio_sq=ratio_sq,
            ratio_cnt=ratio_cnt,
            slack_cnt=slack_cnt,
            done=done,
            steps=s.steps + 1,
            last_improve=last_improve,
            res_step=res_step,
        )

    final = jax.lax.while_loop(cond, body, state)
    ids = jnp.where(final.res_d < FLOAT_MAX, final.res_ids, -1)
    if debug_state:
        return ids, final.res_d, final
    return ids, final.res_d
