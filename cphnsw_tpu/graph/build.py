"""Graph construction orchestrator: NNDescent -> alpha-CNG -> residual codes.

Accelerator re-expression of optimize_graph_adaptive
(/root/reference/include/cphnsw/graph/graph_refinement.hpp:438-553) plus the
FastScan neighbor-block materialization (prune_and_write, :30-68):

  1. centroid entry point;
  2. adaptive NNDescent (graph/nndescent.py);
  3. data-derived alpha/tau/alpha_max (graph/stats.py);
  4. alpha-CNG prune of every node's working list (graph/pruning.py);
  5. reverse-edge pass: re-prune with reverse candidates merged in;
  6. per-edge residual re-encoding — every selected neighbor is quantized
     relative to its parent vertex (SymphonyQG-style), batched over all
     N*R edges in node chunks;
  7. hub entry point (max-degree among the sqrt(n) nodes nearest the
     centroid, rabitq_graph.hpp:280-328) + BFS reorder for locality
     (:204-278).

The result is a flat SoA neighbor store (ids / packed planes / nop / ip_qo /
ip_cp / wpc), the device layout replacing FastScanNeighborBlock.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.graph import nndescent, pruning, stats as gstats
from cphnsw_tpu.ops import hadamard, pack, quantize



@jax.tree_util.register_pytree_node_class
class NeighborStore:
    """Per-edge search data with a FUSED per-node row layout.

    `fused` packs everything the search step needs for one node into ONE
    contiguous int32 row, channel-contiguous so kernels slice channels
    without transposing reshapes (Mosaic restriction):
    [ids (R)] [nop (R)] [ip_qo (R)] [ip_cp (R)] [wpc (R)] [planes
    (R*bits*W) u32-bitcast, plane-major (plane 0 = MSB first) with words
    inner] [zero pad].  One ~1 KB row gather per popped node replaces
    three ~0.5 KB gathers.  Rows are zero-padded to a multiple of 128
    int32 so the row gather lands on lane-aligned tiles.  `ids` is also
    kept standalone (graph algorithms use it heavily); logical views
    derive from `fused`.

    Registered as a pytree with (r, bits, words) as static aux data so the
    layout metadata stays python-level under jit.
    """

    def __init__(self, ids, fused, r: int, bits: int, words: int):
        self.ids = ids      # (N, R) int32, -1 = none
        self.fused = fused  # (N, F) int32, F = R*(1+4+bits*W) + pad
        self.r = r
        self.bits = bits
        self.words = words

    def tree_flatten(self):
        return (self.ids, self.fused), (self.r, self.bits, self.words)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)

    @property
    def aux(self):
        r = self.r
        chans = [
            jax.lax.bitcast_convert_type(
                self.fused[:, (1 + c) * r : (2 + c) * r], jnp.float32
            )
            for c in range(4)
        ]
        return jnp.stack(chans, axis=-1)

    @property
    def planes(self):
        n = self.fused.shape[0]
        end = (5 + self.bits * self.words) * self.r
        p = self.fused[:, 5 * self.r : end]
        pw = jax.lax.bitcast_convert_type(p, jnp.uint32).reshape(
            n, self.bits, self.words, self.r
        )
        return jnp.moveaxis(pw, 3, 1)  # (N, R, bits, W)

    @property
    def nop(self):
        return self.aux[..., 0]

    @property
    def ip_qo(self):
        return self.aux[..., 1]

    @property
    def ip_cp(self):
        return self.aux[..., 2]

    @property
    def wpc(self):
        return self.aux[..., 3]

    @staticmethod
    def pack(ids, planes, aux):
        """Build the fused layout from logical arrays."""
        n, r = ids.shape
        bits, w = planes.shape[-2], planes.shape[-1]
        aux_i = jax.lax.bitcast_convert_type(
            aux.astype(jnp.float32), jnp.int32
        )  # (N, R, 4)
        chans = [aux_i[:, :, c] for c in range(4)]
        # planes stored plane-major (MSB plane first), words inner: fused
        # col 5R + (b*W + w)*R + rr (kernels slice a full (N-block, R)
        # tile per (bit-plane, word); the MSB prefix is contiguous for the
        # two-stage N-bit skip)
        planes_i = jnp.moveaxis(
            jax.lax.bitcast_convert_type(planes, jnp.int32), 1, 3
        ).reshape(n, bits * w * r)
        fused = jnp.concatenate([ids, *chans, planes_i], axis=1)
        if fused.shape[1] % 128:
            fused = jnp.pad(
                fused, [(0, 0), (0, 128 - fused.shape[1] % 128)]
            )
        return NeighborStore(
            ids=ids, fused=fused, r=r, bits=bits, words=w
        )


@dataclass
class BuildResult:
    neighbors: NeighborStore
    entry_point: int
    stats: gstats.GraphStats
    old_to_new: np.ndarray  # BFS permutation applied to all arrays
    raw: jax.Array          # permuted
    norm_sq: jax.Array
    node_nop: jax.Array     # permuted ||x - centroid||


def _chunked_prune(
    raw, norm_sq, cand_ids, cand_dists, node_nop, alpha, tau, alpha_max,
    r, error_tolerance, chunk=None,
):
    n = cand_ids.shape[0]
    if chunk is None:
        chunk = nndescent._chunk_for(
            n, cand_ids.shape[1], raw.shape[1], 8192
        )
    b = min(chunk, n)

    # single jitted dispatch per fixed-size chunk (remote backends make
    # eager op-by-op dispatch prohibitively slow); device-side accumulation
    @jax.jit
    def _prune_chunk(raw, norm_sq, node_nop, cand_ids, cand_dists, start):
        idx = jnp.minimum(start + jnp.arange(b), n - 1)
        ci, cd = pruning.prepare_candidates(cand_ids[idx], cand_dists[idx])
        pd = pruning.candidate_pair_dists(raw, norm_sq, ci)
        err = jnp.where(
            ci >= 0, error_tolerance * node_nop[jnp.maximum(ci, 0)], 0.0
        )
        return pruning.select_alpha_cng(
            ci, cd, pd, err,
            jnp.float32(alpha), jnp.float32(tau), jnp.float32(alpha_max), r,
        )

    parts = []
    for start in range(0, n, b):
        out = _prune_chunk(
            raw, norm_sq, node_nop, cand_ids, cand_dists, jnp.int32(start)
        )
        jax.block_until_ready(out)  # bound live chunk transients
        parts.append(out)
    if len(parts) == 1:
        si, sd = parts[0]
    else:
        si = jnp.concatenate([p[0] for p in parts], axis=0)
        sd = jnp.concatenate([p[1] for p in parts], axis=0)
    return si[:n], sd[:n]


def _reverse_candidates(sel_ids, sel_dists, r_rev: int):
    """Reverse edges capped at r_rev per target, keeping the closest
    sources (replacing the unbounded reverse_cands vectors,
    graph_refinement.hpp:393-402)."""
    from cphnsw_tpu.utils import native

    nat = native.reverse_topk(
        np.asarray(sel_ids), np.asarray(sel_dists), r_rev
    )
    if nat is not None:
        return jnp.asarray(nat[0]), jnp.asarray(nat[1])

    n, r = sel_ids.shape
    src = np.broadcast_to(
        np.arange(n, dtype=np.int64)[:, None], (n, r)
    ).ravel()
    tgt = np.asarray(sel_ids).astype(np.int64).ravel()
    d = np.asarray(sel_dists).ravel()
    valid = tgt >= 0
    src, tgt, d = src[valid], tgt[valid], d[valid]
    order = np.lexsort((d, tgt))
    src, tgt, d = src[order], tgt[order], d[order]
    first = np.searchsorted(tgt, tgt, side="left")
    rank = np.arange(tgt.size) - first
    keep = rank < r_rev
    rev_ids = np.full((n, r_rev), -1, dtype=np.int32)
    rev_dists = np.full((n, r_rev), np.finfo(np.float32).max, dtype=np.float32)
    rev_ids[tgt[keep], rank[keep]] = src[keep]
    rev_dists[tgt[keep], rank[keep]] = d[keep]
    return jnp.asarray(rev_ids), jnp.asarray(rev_dists)


def encode_neighbor_blocks(
    raw, sel_ids, signs, bits: int, chunk: int | None = None
) -> NeighborStore:
    """Edge-residual encoding of all selected edges, node-chunked.

    Equivalent of the per-edge compute_neighbor_aux calls inside
    prune_and_write (graph_refinement.hpp:53-66), batched: each chunk
    rotates+quantizes chunk*R residual vectors in one program."""
    n, r = sel_ids.shape
    p = signs.shape[-1]
    if chunk is None:
        chunk = nndescent._chunk_for(n, r, p, 4096)
    b = min(chunk, n)

    # single jitted dispatch per fixed-size chunk; invalid edges are
    # masked device-side
    @jax.jit
    def _encode_chunk(raw, sel_ids, start):
        idx = jnp.minimum(start + jnp.arange(b), n - 1)
        ids_c = sel_ids[idx]
        parents = raw[idx]
        nbr_vecs = raw[jnp.maximum(ids_c, 0)]
        rot_parents = hadamard.rotate(parents, signs)
        par_rep = jnp.repeat(parents, r, axis=0)
        rot_rep = jnp.repeat(rot_parents, r, axis=0)
        enc = quantize.encode_residuals(
            par_rep, nbr_vecs.reshape(b * r, p), rot_rep, signs, bits
        )
        u = enc.u.reshape(b, r, p)
        invalid = ids_c < 0
        u = jnp.where(invalid[:, :, None], 0, u)
        return (
            pack.pack_planes(u, bits),
            jnp.where(invalid, 0.0, enc.nop.reshape(b, r)),
            jnp.where(invalid, 0.0, enc.ip_qo.reshape(b, r)),
            jnp.where(invalid, 0.0, enc.ip_cp.reshape(b, r)),
            jnp.where(invalid, 0, u.sum(-1).astype(jnp.int32)),
        )

    parts = []
    for start in range(0, n, b):
        out = _encode_chunk(raw, sel_ids, jnp.int32(start))
        jax.block_until_ready(out)  # bound live chunk transients
        parts.append(out)
    if len(parts) == 1:
        pl, no, qo, cp, wp = parts[0]
    else:
        pl = jnp.concatenate([x[0] for x in parts], axis=0)
        no = jnp.concatenate([x[1] for x in parts], axis=0)
        qo = jnp.concatenate([x[2] for x in parts], axis=0)
        cp = jnp.concatenate([x[3] for x in parts], axis=0)
        wp = jnp.concatenate([x[4] for x in parts], axis=0)
    aux = jnp.stack(
        [no[:n], qo[:n], cp[:n], wp[:n].astype(jnp.float32)], axis=-1
    )
    return NeighborStore.pack(jnp.asarray(sel_ids), pl[:n], aux)


def find_hub_entry(raw, norm_sq, centroid, sel_ids) -> int:
    """Max-degree node among the sqrt(n) nearest to the centroid
    (rabitq_graph.hpp:280-328)."""
    n = raw.shape[0]
    top_k = max(1, int(math.isqrt(n)))

    @jax.jit
    def _near(raw, centroid):
        d = jnp.sum((raw - centroid) ** 2, axis=-1)
        return jax.lax.top_k(-d, top_k)[1]

    near = np.asarray(_near(raw, centroid))
    degrees = (np.asarray(sel_ids)[near] >= 0).sum(-1)
    return int(near[int(np.argmax(degrees))])


def bfs_order(sel_ids: np.ndarray, entry: int) -> np.ndarray:
    """BFS permutation old_to_new (rabitq_graph.hpp:204-278); native C
    implementation with a numpy per-level fallback."""
    from cphnsw_tpu.utils import native

    nat = native.bfs_order(sel_ids, entry)
    if nat is not None:
        return nat

    n, _ = sel_ids.shape
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0

    def run(start):
        nonlocal pos
        if visited[start]:
            return
        frontier = np.array([start], dtype=np.int64)
        visited[start] = True
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            nxt = sel_ids[frontier].ravel()
            nxt = nxt[nxt >= 0]
            nxt = np.unique(nxt)
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt

    run(entry)
    for i in range(n):
        if not visited[i]:
            run(i)

    old_to_new = np.empty(n, dtype=np.int64)
    old_to_new[order] = np.arange(n)
    return old_to_new


def build_graph(
    raw: jax.Array,
    norm_sq: jax.Array,
    node_nop: jax.Array,
    signs: jax.Array,
    bits: int,
    r: int,
    seed: int = 42,
    verbose: bool = False,
) -> BuildResult:
    import time as _time

    n, p = raw.shape
    error_tolerance = 1.0 / math.sqrt(float(p))

    def _tick(label, t0):
        if verbose:
            print(f"build_graph/{label}: {_time.time() - t0:.1f}s", flush=True)
        return _time.time()

    t = _time.time()
    centroid = jnp.mean(raw, axis=0)

    wg = nndescent.run_adaptive(raw, norm_sq, r, seed=seed, verbose=verbose)
    t = _tick("nndescent", t)

    sample = int(math.isqrt(n))
    st = gstats.derive_graph_stats(
        raw, norm_sq, wg.ids, wg.dists, sample_size=max(sample, 16)
    )
    t = _tick("stats", t)

    sel_ids, sel_dists = _chunked_prune(
        raw, norm_sq, wg.ids, wg.dists, node_nop,
        st.alpha, st.tau, st.alpha_max, r, error_tolerance,
    )
    t = _tick("prune", t)

    # Reverse-edge pass: merge reverse candidates and re-prune every node.
    rev_ids, rev_dists = _reverse_candidates(sel_ids, sel_dists, r_rev=2 * r)
    all_ids = jnp.concatenate([sel_ids, rev_ids], axis=1)
    all_dists = jnp.concatenate([sel_dists, rev_dists], axis=1)
    sel_ids, sel_dists = _chunked_prune(
        raw, norm_sq, all_ids, all_dists, node_nop,
        st.alpha, st.tau, st.alpha_max, r, error_tolerance,
    )
    t = _tick("reverse+prune", t)

    hub = find_hub_entry(raw, norm_sq, centroid, sel_ids)
    old_to_new = bfs_order(np.asarray(sel_ids), hub)
    new_to_old = np.empty_like(old_to_new)
    new_to_old[old_to_new] = np.arange(n)

    sel_np = np.asarray(sel_ids)
    remapped = np.where(sel_np >= 0, old_to_new[np.maximum(sel_np, 0)], -1)
    sel_ids_perm = jnp.asarray(remapped[new_to_old].astype(np.int32))
    raw_perm = raw[jnp.asarray(new_to_old)]
    norm_perm = norm_sq[jnp.asarray(new_to_old)]
    nop_perm = node_nop[jnp.asarray(new_to_old)]
    t = _tick("reorder", t)

    neighbors = encode_neighbor_blocks(raw_perm, sel_ids_perm, signs, bits)
    t = _tick("encode_blocks", t)
    entry = int(old_to_new[hub])

    return BuildResult(
        neighbors=neighbors,
        entry_point=entry,
        stats=st,
        old_to_new=old_to_new,
        raw=raw_perm,
        norm_sq=norm_perm,
        node_nop=nop_perm,
    )
