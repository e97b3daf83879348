"""Mesh-sharded search: database sharding + query data-parallelism.

The distributed component with no reference counterpart (SURVEY.md
section 2.3): the reference is a single-process OpenMP library; its only
parallelism is shared-memory threads.  Here the index scales out over a
device mesh instead:

  * mesh axes ("data", "model"): query batches shard over "data";
    the database — codes, graph, raw vectors — shards over "model"
    (each model-shard owns a contiguous slice of the dataset and builds
    its own independent CP-HNSW subgraph);
  * one search step = shard_map over the mesh: every device runs the full
    search on its local shard for its local query block, offsets local
    ids to global, then all-gathers per-shard top-k along "model" and
    merges — the cross-device top-k all-gather merge from
    BASELINE.json's north star (XLA lowers the all_gather to NCCL on
    GPUs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cphnsw_tpu.graph.build import NeighborStore
from cphnsw_tpu.search import beam, scan

FLOAT_MAX = jnp.float32(jnp.finfo(jnp.float32).max)


class ShardedStore(NamedTuple):
    """All per-shard arrays stacked on a leading shard axis (S, ...)."""

    raw: jax.Array            # (S, N_s, P)
    norm_sq: jax.Array        # (S, N_s)
    nbr_ids: jax.Array        # (S, N_s, R)
    nbr_planes: jax.Array     # (S, N_s, R, B, W)
    nbr_aux: jax.Array        # (S, N_s, R, 4)
    entry_candidates: jax.Array  # (S, M)
    orig_ids: jax.Array       # (S, N_s) int32: caller's original vector
    #                           index per local node (>= n for pad rows)


def make_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_data * n_model, (
        f"need {n_data * n_model} devices, have {devices.size}"
    )
    grid = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def shard_store(store: ShardedStore, mesh: Mesh) -> ShardedStore:
    """Place each stacked array with its leading axis sharded over
    "model" (replicated over "data")."""
    spec = NamedSharding(mesh, P("model"))
    return ShardedStore(*(jax.device_put(a, spec) for a in store))


@functools.partial(
    jax.jit,
    static_argnames=(
        "bits", "k", "beam_cap", "max_steps", "n_seeds", "mesh", "n_real"
    ),
)
def sharded_search(
    store: ShardedStore,
    queries: jax.Array,
    params: beam.SearchParams,
    signs: jax.Array,
    mesh: Mesh,
    bits: int,
    k: int,
    beam_cap: int = 128,
    max_steps: int = 512,
    n_seeds: int = 4,
    n_real: int | None = None,
):
    """Global top-k over all shards.

    queries: (Q, dim) with Q divisible by the "data" axis size.  Returns
    (ids (Q, k) int32 GLOBAL ids = shard * N_s + local, dists (Q, k)).

    Returned ids are the CALLER'S ORIGINAL vector indices (the per-shard
    orig_ids arrays are applied device-side before the merge).  n_real:
    number of genuine (un-padded) vectors; rows whose original id >= n_real
    are shard-padding duplicates and are masked out before the cross-shard
    merge so they can never displace a distinct neighbor.
    """

    def local_search(raw, norm_sq, ids, planes, aux, cands, orig, q):
        # shard_map hands us the local block with the sharded axis size 1
        raw, norm_sq = raw[0], norm_sq[0]
        neighbors = NeighborStore.pack(ids[0], planes[0], aux[0])
        local_ids, local_d = beam.search_batch(
            raw, norm_sq, neighbors, cands[0], signs, q, params,
            bits=bits, k=k, beam_cap=beam_cap, max_steps=max_steps,
            n_seeds=n_seeds,
        )
        global_ids = jnp.where(
            local_ids >= 0, orig[0][jnp.maximum(local_ids, 0)], -1
        )
        if n_real is not None:
            pad_row = global_ids >= n_real
            global_ids = jnp.where(pad_row, -1, global_ids)
            local_d = jnp.where(pad_row, FLOAT_MAX, local_d)
        # cross-chip top-k merge along the model axis
        all_ids = jax.lax.all_gather(global_ids, "model", axis=0)  # (S,Q,k)
        all_d = jax.lax.all_gather(local_d, "model", axis=0)
        qn = q.shape[0]
        all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(qn, -1)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(qn, -1)
        neg_top, sel = jax.lax.top_k(-all_d, k)
        return jnp.take_along_axis(all_ids, sel, axis=1), -neg_top

    in_specs = (
        *(P("model") for _ in range(7)),
        P("data", None),
    )
    out_specs = (P("data", None), P("data", None))
    return shard_map(
        local_search, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )(*store, queries)


# --------------------------------------------------------------------------
# Sharded full-database scan: the north-star scale-out configuration
# (BASELINE.md "Deep100M sharded: per-chip scan + cross-chip top-k
# all-gather merge").  Each model-shard owns a contiguous row slice of the
# scan store (packed code planes + folded node constants + raw vectors);
# one search step = shard_map{ local int8 scan -> local exact-L2 top-k ->
# all_gather along "model" -> merge }.  Per-shard top-k lists are exact
# within their shard, so the merged top-k equals the single-chip result.
# --------------------------------------------------------------------------


class ShardedScanStore(NamedTuple):
    """Model-axis row slices of a ScanArrays store, stacked on (S, ...)."""

    planes: jax.Array     # (S, N_s, B, W) uint32 packed code planes
    node_aux: jax.Array   # (S, 6, N_s)
    raw: jax.Array        # (S, N_s, P)
    norm_sq: jax.Array    # (S, N_s)


def shard_scan_arrays(
    arrays: scan.ScanArrays, n_shards: int
) -> ShardedScanStore:
    """Slice a single-chip ScanArrays into n_shards contiguous row blocks.

    The store's pad rows (node_aux row 0 == PAD_SCORE) land in the last
    shard and rank last there, exactly as on one chip.  Rows are padded to
    a multiple of n_shards*256 so every shard gets the same static shape.
    """
    n_pad, p = arrays.raw.shape
    per = -(-n_pad // (n_shards * 256)) * 256
    total = per * n_shards
    if total != n_pad:
        extra = total - n_pad
        b, w = arrays.planes.shape[1:]
        planes = jnp.concatenate(
            [arrays.planes, jnp.zeros((extra, b, w), jnp.uint32)]
        )
        pad_aux = jnp.zeros((6, extra), jnp.float32).at[0].set(scan.PAD_SCORE)
        node_aux = jnp.concatenate([arrays.node_aux, pad_aux], axis=1)
        raw = jnp.concatenate([arrays.raw, jnp.zeros((extra, p))])
        norm_sq = jnp.concatenate([arrays.norm_sq, jnp.zeros(extra)])
    else:
        planes, node_aux, raw, norm_sq = (
            arrays.planes, arrays.node_aux, arrays.raw, arrays.norm_sq
        )
    b, w = planes.shape[1:]
    return ShardedScanStore(
        planes=planes.reshape(n_shards, per, b, w),
        node_aux=node_aux.reshape(6, n_shards, per).transpose(1, 0, 2),
        raw=raw.reshape(n_shards, per, p),
        norm_sq=norm_sq.reshape(n_shards, per),
    )


def shard_scan_store(store: ShardedScanStore, mesh: Mesh) -> ShardedScanStore:
    """Place each stacked array with its leading (shard) axis on "model"."""
    spec = NamedSharding(mesh, P("model"))
    return ShardedScanStore(*(jax.device_put(a, spec) for a in store))


@functools.partial(
    jax.jit,
    static_argnames=(
        "kappa", "k", "top_c", "chunk", "n_eq", "rem", "mesh", "fused"
    ),
)
def sharded_scan_search(
    store: ShardedScanStore,
    queries: jax.Array,
    signs: jax.Array,
    affine_a,
    affine_b,
    n,
    mesh: Mesh,
    kappa: float,
    k: int,
    top_c: int,
    chunk: int,
    n_eq: int,
    rem: int,
    fused: bool = False,
):
    """Global top-k over all scan shards.

    queries: (Q, dim<=P) with Q divisible by the "data" axis size; ids
    returned are GLOBAL store rows (shard * N_s + local), -1 for pad.
    (chunk, n_eq, rem) is the LOCAL chunk plan (scan.chunk_plan of the
    per-shard row count).  n is the global count of genuine rows; every
    row the caller padded ranks last via its PAD_SCORE node constant.
    """

    def local_search(planes, aux, raw, norm_sq, q):
        arrays = scan.ScanArrays(
            planes=planes[0], node_aux=aux[0], raw=raw[0],
            norm_sq=norm_sq[0],
        )
        n_local = arrays.raw.shape[0]
        # a shard can contribute at most its own row count; the merged
        # width S * k_local >= k because k <= n <= S * n_local
        k_local = min(k, n_local)
        base = jax.lax.axis_index("model").astype(jnp.int32) * n_local
        # local ids are valid iff their global row is a genuine vector
        local_ids, local_d = scan.scan_search(
            arrays, q, signs, affine_a, affine_b,
            jnp.maximum(jnp.minimum(n - base, n_local), 0),
            kappa=kappa, k=k_local,
            top_c=max(min(top_c, n_local), k_local),
            chunk=chunk, n_eq=n_eq, rem=rem, fused=fused,
        )
        global_ids = jnp.where(local_ids >= 0, local_ids + base, -1)
        all_ids = jax.lax.all_gather(global_ids, "model", axis=0)  # (S,Q,k)
        all_d = jax.lax.all_gather(local_d, "model", axis=0)
        qn = q.shape[0]
        all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(qn, -1)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(qn, -1)
        neg_top, sel = jax.lax.top_k(-all_d, k)
        ids = jnp.take_along_axis(all_ids, sel, axis=1)
        return jnp.where(neg_top > -FLOAT_MAX, ids, -1), -neg_top

    in_specs = (*(P("model") for _ in range(4)), P("data", None))
    out_specs = (P("data", None), P("data", None))
    return shard_map(
        local_search, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )(*store, queries)


def _shard_per_rows(n: int, n_shards: int) -> int:
    """Per-shard padded row count: ceil(n / S) rounded up to 256."""
    return -(-(-(-n // n_shards)) // 256) * 256


def _assemble_sharded(blocks: list, mesh: Mesh) -> jax.Array:
    """Stack per-shard blocks into ONE (S, ...) array sharded P("model")
    over the mesh WITHOUT ever forming the full array on any device:
    each mesh device receives only its own shard's block (replicated
    across the "data" axis), and the global array is assembled from the
    per-device buffers (jax.make_array_from_single_device_arrays)."""
    s_count = len(blocks)
    shape = (s_count, *np.shape(blocks[0]))
    sharding = NamedSharding(mesh, P("model"))
    devs = mesh.devices  # (n_data, n_model)
    bufs = []
    for di in range(devs.shape[0]):
        for s in range(devs.shape[1]):
            blk = blocks[s]
            if not isinstance(blk, jax.Array):
                blk = np.asarray(blk)
            bufs.append(jax.device_put(blk[None], devs[di, s]))
    return jax.make_array_from_single_device_arrays(shape, sharding, bufs)


def _derive_sharded_scan_budget(
    shard_arrays: list,
    shard_n: list,
    per: int,
    n: int,
    signs_h: np.ndarray,
    affine_a: float,
    affine_b: float,
    kappa: float,
    seed: int,
    n_queries: int = 256,
) -> "scan.CandidateBudget":
    """derive_candidate_budget decomposed over shards: every device-side
    step runs on one shard's arrays only (on that shard's own device).

    Phase A: per-shard exact top-k of the sample queries -> host merge to
    the global true top-k (ids + nn distances).
    Phase B: each true neighbor's estimate score, computed on its HOME
    shard (scan.est_scores_of) and scattered into the (Q, T) matrix.
    Phase C: per-shard counts of rows scoring <= each true neighbor
    (scan.count_leq), summed across shards = global estimate ranks.
    The rank-quantile -> top_c math is then identical to the single-chip
    derivation (scan.ranks_from_counts / budget_from_cohorts).
    """
    rng = np.random.default_rng(seed)
    m = int(min(n_queries, n))
    ids = rng.choice(n, size=m, replace=False)
    a_f, b_f = float(affine_a), float(affine_b)

    # fetch the sampled rows from their home shards (numpy indexers so
    # each gather stays on its shard's device)
    p = int(shard_arrays[0].raw.shape[1])
    db_rows = np.empty((m, p), np.float32)
    for s, arrays in enumerate(shard_arrays):
        sel = (ids // per) == s
        if sel.any():
            loc = (ids[sel] - s * per).astype(np.int32)
            db_rows[sel] = np.asarray(arrays.raw[loc])

    def global_topk(queries_np: np.ndarray, k: int):
        """Host merge of per-shard exact top-k -> (m, k) global ids+d."""
        qnorm = (queries_np * queries_np).sum(-1)
        parts_i, parts_d = [], []
        for s, arrays in enumerate(shard_arrays):
            k_loc = min(k, max(int(shard_n[s]), 1))
            ids_s, d_s = scan._true_topk_chunked(
                arrays.raw, arrays.norm_sq, queries_np, qnorm,
                int(shard_n[s]), k_loc,
            )
            parts_i.append(np.asarray(ids_s) + s * per)
            parts_d.append(np.asarray(d_s))
        cat_i = np.concatenate(parts_i, axis=1)
        cat_d = np.concatenate(parts_d, axis=1)
        order = np.argsort(cat_d, axis=1)[:, :k]
        return (
            np.take_along_axis(cat_i, order, axis=1),
            np.take_along_axis(cat_d, order, axis=1),
        )

    _, d2 = global_topk(db_rows, min(2, n))
    nn_dist = np.sqrt(np.maximum(d2[:, -1], 0.0))  # excl. self

    anchors = sorted({min(a, n) for a in scan.RANK_ANCHORS})
    k_max = anchors[-1]
    per_cohort = []
    for scale in (1.0, 3.0):
        noise = rng.standard_normal((m, p)).astype(np.float32) / np.sqrt(p)
        queries = db_rows + noise * (scale * nn_dist)[:, None]
        true_ids, _ = global_topk(queries, k_max)
        home = true_ids // per
        # Phase B: score each true neighbor on its home shard
        est_t = np.zeros((m, k_max), np.float32)
        for s, arrays in enumerate(shard_arrays):
            sel = home == s
            if not sel.any():
                continue
            loc = np.where(sel, true_ids - s * per, 0).astype(np.int32)
            est_s = np.asarray(scan.est_scores_of(
                arrays, queries, loc, signs_h, a_f, b_f, float(kappa),
            ))
            est_t[sel] = est_s[sel]
        # Phase C: global rank = sum of per-shard counts
        counts = np.zeros((m, k_max), np.int64)
        for arrays in shard_arrays:
            counts += np.asarray(scan.count_leq(
                arrays, queries, est_t, signs_h, a_f, b_f, float(kappa),
            ))
        per_cohort.append(scan.ranks_from_counts(counts, anchors))
    return scan.budget_from_cohorts(per_cohort, anchors)


class ShardedScanIndex:
    """ScanIndex semantics with the store partitioned over the mesh's
    "model" axis and queries data-parallel over "data".

    The build is SHARD-NATIVE: each model
    shard's rows are staged, encoded, and folded on that shard's own
    device — no stage ever materializes more than one shard's store on a
    single device, so stores larger than one chip's HBM build as long as
    each 1/S slice fits.  Global statistics come from cross-shard
    reductions: the centroid from per-shard sums, the affine calibration
    from pooled per-shard sample pairs (scan.fit_scan_affine), and the
    candidate budget from per-shard rank counts summed across shards
    (_derive_sharded_scan_budget) — each in law identical to its
    single-chip counterpart over the union of the data.  Every search
    runs per-chip scans and one cross-chip all-gather top-k merge.
    """

    def __init__(self, dim: int, bits: int = 1, seed: int = 42,
                 metric: str = "l2"):
        from cphnsw_tpu.api.scan_index import ScanIndex

        self._inner = ScanIndex(dim, bits=bits, rotation_seed=seed,
                                metric=metric)
        self.dim = dim
        self.bits = bits
        self._mesh = None
        self._store = None

    def build(self, vectors, mesh: Mesh):
        """Shard-native build.  `vectors` is an (n, dim) host or device
        array, or a callable provider(shard, start_row, rows) -> (rows,
        dim) block for stores too large to materialize anywhere at once.
        With a provider, pass n via `provider.n_rows` attribute."""
        inner = self._inner
        n_model = mesh.shape["model"]
        build_devs = [mesh.devices[0, s] for s in range(n_model)]

        if callable(vectors):
            n = int(vectors.n_rows)

            def get_block(s, start, rows):
                return np.ascontiguousarray(
                    vectors(s, start, rows), dtype=np.float32
                )
        else:
            if vectors.ndim != 2 or vectors.shape[1] != inner._dim:
                raise ValueError(
                    f"expected (n, {inner._dim}) array, got {vectors.shape}"
                )
            n = int(vectors.shape[0])

            def get_block(s, start, rows):
                blk = vectors[start:start + rows]
                if isinstance(blk, np.ndarray):
                    blk = np.ascontiguousarray(blk, dtype=np.float32)
                return blk
        if n == 0:
            raise ValueError("build requires at least one vector.")
        inner._n = n
        per = _shard_per_rows(n, n_model)
        shard_src = [
            (s * per, max(0, min(n - s * per, per)))
            for s in range(n_model)
        ]

        # ---- pass 1: global centroid (+ ip norm bound) from shard sums
        total = np.zeros(inner._dim, np.float64)
        bound_sq = 0.0
        norm_sums = []  # per-shard (rows,) squared norms (ip only)
        for s, (start, rows) in enumerate(shard_src):
            if rows == 0:
                norm_sums.append(None)
                continue
            blk = jax.device_put(get_block(s, start, rows), build_devs[s])
            sums = np.asarray(jnp.sum(blk.astype(jnp.float32), axis=0))
            total += sums.astype(np.float64)
            if inner._metric == "ip":
                nsq = np.asarray(
                    jnp.sum(blk.astype(jnp.float32) ** 2, axis=1)
                )
                norm_sums.append(nsq)
                bound_sq = max(bound_sq, float(nsq.max()))
            else:
                norm_sums.append(None)
            del blk
        centroid_in = (total / n).astype(np.float32)
        if inner._metric == "ip":
            inner._ip_norm_bound = bound_sq
            # exact mean of the augmentation column sqrt(bound - |x|^2):
            # computable from the pass-1 norms once the global bound is
            # known, so the sharded centroid matches the single-chip one
            aug_mean = float(np.mean(np.concatenate([
                np.sqrt(np.maximum(bound_sq - nsq, 0.0))
                for nsq in norm_sums if nsq is not None
            ])))
            centroid_h = np.concatenate(
                [centroid_in, [aug_mean]]
            ).astype(np.float32)
        else:
            centroid_h = centroid_in
        # centroid of the PADDED coordinates (ip aug column handled below;
        # zero-padding adds zero coordinates whose mean is zero)
        centroid_pad = np.zeros(inner._padded, np.float32)
        centroid_pad[: len(centroid_h)] = centroid_h
        signs_h = np.asarray(inner._signs)

        # ---- pass 2: per-shard stage -> encode -> calibration samples
        kappa = float((1 << self.bits) - 1)
        shard_parts = []  # dicts of device arrays per shard
        samples = []
        node_host = {k: [] for k in ("nop", "ip_qo", "ip_cp", "wpc")}
        ip_aug_mean = 0.0
        for s, (start, rows) in enumerate(shard_src):
            dev = build_devs[s]
            if rows:
                blk = jax.device_put(get_block(s, start, rows), dev)
                blk = blk.astype(jnp.float32)
                if inner._metric == "ip":
                    norms_sq = jnp.sum(blk ** 2, axis=1)
                    aug = jnp.sqrt(jnp.maximum(bound_sq - norms_sq, 0.0))
                    blk = jnp.concatenate([blk, aug[:, None]], axis=1)
            else:
                blk = jax.device_put(
                    np.zeros((0, inner._inner_dim), np.float32), dev
                )
            raw_s, norm_sq_s = scan.pad_store_and_norms(
                blk, rows=per, cols=inner._padded
            )
            del blk
            cen_dev = jax.device_put(centroid_pad, dev)
            signs_dev = jax.device_put(inner._signs, dev)
            planes_s, nop_s, qo_s, cp_s, wpc_s = scan.encode_scan_store(
                raw_s, cen_dev, signs_dev, self.bits
            )
            if rows:
                samples.append(scan.calibration_samples(
                    raw_s, planes_s, nop_s, qo_s, cp_s, wpc_s, cen_dev,
                    signs_dev, rows, self.bits,
                    num_samples=max(256, 2000 // n_model),
                    seed=inner._seed + 99999 + s,
                ))
            node_host["nop"].append(np.asarray(nop_s[:rows]))
            node_host["ip_qo"].append(np.asarray(qo_s[:rows]))
            node_host["ip_cp"].append(np.asarray(cp_s[:rows]))
            node_host["wpc"].append(np.asarray(wpc_s[:rows]))
            shard_parts.append(dict(
                planes=planes_s, nop=nop_s, ip_qo=qo_s, ip_cp=cp_s,
                wpc=wpc_s, raw=raw_s, norm_sq=norm_sq_s, dev=dev,
                rows=rows,
            ))

        # ---- global affine fit from pooled shard samples
        a, b, floor = scan.fit_scan_affine(samples)
        inner._affine_a, inner._affine_b, inner._ip_qo_floor = a, b, floor

        # ---- fold node constants per shard (local genuine-row counts)
        shard_arrays = []
        shard_n = []
        for part in shard_parts:
            aux_s = scan.fold_node_constants(
                part["nop"], part["ip_qo"], part["ip_cp"], part["wpc"],
                jax.device_put(np.float32(floor), part["dev"]),
                jax.device_put(np.int32(part["rows"]), part["dev"]),
            )
            shard_arrays.append(scan.ScanArrays(
                planes=part["planes"], node_aux=aux_s, raw=part["raw"],
                norm_sq=part["norm_sq"],
            ))
            shard_n.append(part["rows"])

        # ---- candidate budget from cross-shard rank counts
        inner._budget = _derive_sharded_scan_budget(
            shard_arrays, shard_n, per, n, signs_h, a, b, kappa,
            seed=inner._seed + 4242,
        )

        # ---- place the final store on the mesh (per-device buffers only)
        self._store = ShardedScanStore(
            planes=_assemble_sharded([a.planes for a in shard_arrays], mesh),
            node_aux=_assemble_sharded(
                [a.node_aux for a in shard_arrays], mesh
            ),
            raw=_assemble_sharded([a.raw for a in shard_arrays], mesh),
            norm_sq=_assemble_sharded(
                [a.norm_sq for a in shard_arrays], mesh
            ),
        )
        self._mesh = mesh
        inner._node_host = {
            k: np.concatenate(v) for k, v in node_host.items()
        }
        inner._centroid = jnp.asarray(centroid_pad)
        inner._stage_scalars()
        inner._arrays = None
        inner._finalized = True
        inner._needs_build = False
        return self

    def _attach(self, mesh: Mesh):
        n_model = mesh.shape["model"]
        self._store = shard_scan_store(
            shard_scan_arrays(self._inner._arrays, n_model), mesh
        )
        # free the single-chip copy; the facade keeps host copies for save
        self._inner._arrays = None
        self._mesh = mesh
        return self

    @property
    def size(self) -> int:
        return self._inner.size

    def search_batch(self, queries: np.ndarray, k: int = 10):
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        inner = self._inner
        if queries.ndim != 2 or queries.shape[1] != inner._dim:
            raise ValueError(
                f"expected (q, {inner._dim}) float32 queries, got "
                f"{queries.shape}"
            )
        k = max(int(k), 1)
        k_eff = min(k, inner._n)
        if inner._metric == "ip":
            queries = np.concatenate(
                [queries, np.zeros((len(queries), 1), np.float32)], axis=1
            )
        nq = len(queries)
        n_data = self._mesh.shape["data"]
        pad = (-nq) % n_data
        q_in = queries
        if pad:
            q_in = np.concatenate(
                [queries, np.repeat(queries[-1:], pad, axis=0)]
            )
        n_local = int(self._store.raw.shape[1])
        chunk, n_eq, rem = scan.chunk_plan(n_local, len(q_in) // n_data)
        top_c = max(min(inner._budget.top_c(k_eff, inner._n), chunk), k_eff)
        aff_a, aff_b, n_dev = inner._dev_scalars
        ids, dists = sharded_scan_search(
            self._store, jnp.asarray(q_in), inner._signs, aff_a, aff_b,
            n_dev, self._mesh, kappa=float((1 << self.bits) - 1),
            k=k_eff, top_c=top_c, chunk=chunk, n_eq=n_eq, rem=rem,
            fused=scan.use_kernel(),
        )
        ids = np.asarray(ids)[:nq].astype(np.int64)
        dists = np.asarray(dists)[:nq]
        if inner._metric == "ip":
            qn = (queries[:nq, : inner._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(
                dists < np.finfo(np.float32).max,
                (qn + inner._ip_norm_bound - dists) / 2.0,
                -np.inf,
            ).astype(np.float32)
        if k_eff < k:
            pad_i = np.full((nq, k - k_eff), -1, np.int64)
            pad_val = (
                -np.inf if inner._metric == "ip"
                else np.finfo(np.float32).max
            )
            pad_d = np.full((nq, k - k_eff), pad_val, np.float32)
            ids = np.concatenate([ids, pad_i], axis=1)
            dists = np.concatenate([dists, pad_d], axis=1)
        return ids, dists

    # ---------------------------------------------------------- persist
    def save(self, path):
        """Persist via the inner ScanIndex format (the store slicing is
        derived runtime state, re-created at load for whatever mesh)."""
        inner = self._inner
        if inner._node_host is None:
            raise RuntimeError("ShardedScanIndex must be built before save.")
        # rebuild the single-chip arrays view for save if it was released
        if inner._arrays is None:
            self._rehydrate_inner()
        inner.save(path)

    def load(self, path, mesh: Mesh):
        """Host-parse the single-file snapshot, slice it per shard on the
        host, and place each slice on its own mesh device — the full
        store is never staged onto any single chip."""
        inner = self._inner
        header, node_host, raw_h, centroid_h = inner._load_host(path)
        inner._apply_header(header)
        inner._node_host = node_host
        inner._centroid = jnp.asarray(centroid_h)
        inner._stage_scalars()
        inner._arrays = None
        inner._finalized = True
        inner._needs_build = False

        n_model = mesh.shape["model"]
        n = inner._n
        per = _shard_per_rows(n, n_model)
        floor = np.float32(inner._ip_qo_floor)
        build_devs = [mesh.devices[0, s] for s in range(n_model)]

        def host_slice(arr, s, fill=0):
            start = s * per
            blk = arr[start:start + per]
            if len(blk) < per:
                pad_shape = (per - len(blk), *arr.shape[1:])
                blk = np.concatenate(
                    [blk, np.full(pad_shape, fill, arr.dtype)]
                )
            return blk

        planes_b, aux_b, raw_b, norm_b = [], [], [], []
        for s in range(n_model):
            dev = build_devs[s]
            rows = max(0, min(n - s * per, per))
            raw_s, norm_s = scan.pad_store_and_norms(
                jax.device_put(host_slice(raw_h, s), dev),
                rows=per, cols=raw_h.shape[1],
            )
            planes_b.append(
                jax.device_put(host_slice(node_host["planes"], s), dev)
            )
            aux_b.append(scan.fold_node_constants(
                jax.device_put(host_slice(node_host["nop"], s), dev),
                jax.device_put(host_slice(node_host["ip_qo"], s), dev),
                jax.device_put(host_slice(node_host["ip_cp"], s), dev),
                jax.device_put(host_slice(node_host["wpc"], s), dev),
                jax.device_put(floor, dev),
                jax.device_put(np.int32(rows), dev),
            ))
            raw_b.append(raw_s)
            norm_b.append(norm_s)
        self._store = ShardedScanStore(
            planes=_assemble_sharded(planes_b, mesh),
            node_aux=_assemble_sharded(aux_b, mesh),
            raw=_assemble_sharded(raw_b, mesh),
            norm_sq=_assemble_sharded(norm_b, mesh),
        )
        self._mesh = mesh
        return self

    def _rehydrate_inner(self):
        """Reassemble a HOST-side single-chip arrays view (for save):
        np arrays only — the full store must not land on a device."""
        inner = self._inner
        raw = np.asarray(self._store.raw).reshape(
            -1, self._store.raw.shape[-1]
        )
        planes = np.asarray(self._store.planes).reshape(
            -1, *self._store.planes.shape[2:]
        )
        n_pad = scan.store_pad(inner._n)
        inner._node_host = dict(inner._node_host)

        def pad_to(arr):
            if len(arr) < n_pad:
                return np.concatenate([
                    arr,
                    np.zeros((n_pad - len(arr), *arr.shape[1:]), arr.dtype),
                ])
            return arr[:n_pad]

        for k in ("nop", "ip_qo", "ip_cp", "wpc"):
            inner._node_host[k] = pad_to(inner._node_host[k])
        inner._node_host["planes"] = planes[:n_pad]
        # save touches only .raw of this view; np arrays suffice
        inner._arrays = scan.ScanArrays(
            planes=planes[:n_pad], node_aux=None, raw=raw[:n_pad],
            norm_sq=None,
        )


def build_sharded_store(
    vectors: np.ndarray,
    bits: int,
    r: int,
    n_shards: int,
    signs,
    seed: int = 42,
) -> tuple[ShardedStore, np.ndarray]:
    """Partition the dataset into contiguous shards and build one subgraph
    per shard (host loop; each build is itself a batched device program).

    Returns (stacked store, global_new_to_old (n,) mapping global
    shard-local ids back to the caller's vector order)."""
    from cphnsw_tpu.graph import build as gbuild
    from cphnsw_tpu.ops import hadamard

    n = len(vectors)
    per = -(-n // n_shards)
    # pad the dataset so every shard has the same size (duplicates of the
    # last vector; their original ids are >= n so sharded_search masks
    # them out before the cross-shard merge)
    pad = per * n_shards - n
    if pad:
        vectors = np.concatenate([vectors, vectors[-1:].repeat(pad, 0)], 0)

    parts = {k: [] for k in ShardedStore._fields}
    new_to_old = np.empty(per * n_shards, dtype=np.int64)
    p = signs.shape[-1]
    for s in range(n_shards):
        chunk = vectors[s * per : (s + 1) * per]
        raw = hadamard.pad_to(jnp.asarray(chunk, jnp.float32), p)
        norm_sq = jnp.sum(raw * raw, -1)
        centroid = raw.mean(0)
        node_nop = jnp.linalg.norm(raw - centroid, axis=-1)
        res = gbuild.build_graph(
            raw, norm_sq, node_nop, signs, bits=bits, r=r, seed=seed + s
        )
        n2o = np.empty(per, np.int64)
        n2o[res.old_to_new] = np.arange(per)
        new_to_old[s * per : (s + 1) * per] = n2o + s * per
        parts["orig_ids"].append((n2o + s * per).astype(np.int32))

        m = int(min(per, max(16, 4 * np.sqrt(per))))
        rng = np.random.default_rng(seed + 7 + s)
        cand = np.unique(
            np.concatenate([[res.entry_point],
                            rng.choice(per, size=m, replace=False)])
        )
        # fixed-size candidate list across shards (pad with entry)
        m_fixed = int(max(16, 4 * np.sqrt(per)))
        if len(cand) < m_fixed:
            cand = np.concatenate(
                [cand, np.full(m_fixed - len(cand), res.entry_point)]
            )
        cand = cand[:m_fixed]

        parts["raw"].append(np.asarray(res.raw))
        parts["norm_sq"].append(np.asarray(res.norm_sq))
        parts["nbr_ids"].append(np.asarray(res.neighbors.ids))
        parts["nbr_planes"].append(np.asarray(res.neighbors.planes))
        parts["nbr_aux"].append(np.asarray(res.neighbors.aux))
        parts["entry_candidates"].append(cand.astype(np.int32))

    store = ShardedStore(
        **{k: jnp.asarray(np.stack(v)) for k, v in parts.items()}
    )
    return store, new_to_old


def _pooled_params(store, signs, bits, r, padded, max_shards=3):
    """EVT-CRC calibration pooled over up to max_shards shard subgraphs:
    each shard is calibrated independently and the per-field median is
    taken (robust to one unlucky partition; i.i.d. partitions make the
    shards near-exchangeable so the median is a consistent estimate)."""
    from cphnsw_tpu.calibration import calibrate as calib_mod
    from cphnsw_tpu.graph.build import NeighborStore

    n_local = int(store.raw.shape[1])
    profile = calib_mod.IndexProfile.derive(n_local, padded, r, bits)
    per_shard = []
    for s in range(min(int(store.raw.shape[0]), max_shards)):
        nb = NeighborStore.pack(
            store.nbr_ids[s], store.nbr_planes[s], store.nbr_aux[s]
        )
        snap = calib_mod.calibrate(
            store.raw[s], store.norm_sq[s], nb, signs, bits, profile,
        )
        per_shard.append(calib_mod.to_search_params(snap))
    if len(per_shard) == 1:
        return per_shard[0]
    pooled = {
        f: jnp.median(jnp.stack([getattr(p, f) for p in per_shard]), axis=0)
        for f in per_shard[0]._fields
    }
    pooled["gamma_warmup"] = pooled["gamma_warmup"].astype(jnp.int32)
    return beam.SearchParams(**pooled)


def _derive_shard_step_budget(
    store: ShardedStore,
    params: beam.SearchParams,
    signs,
    bits: int,
    r: int,
    seed: int,
    max_shards: int = 2,
) -> dict:
    """Recall-sufficient step budget for the sharded beam path, measured
    on up to max_shards shard subgraphs (same derivation as
    Index._derive_step_budget: one generously-capped k=100 run over
    jittered database rows; budget = p99 of the first step at which the
    final top-k' was present).  The per-anchor max over shards is taken —
    shards are i.i.d. partitions, so this bounds the straggler."""
    rng = np.random.default_rng(seed + 4242)
    budgets = {10: 16, 100: 16}
    n_shards = int(store.raw.shape[0])
    for s in range(min(n_shards, max_shards)):
        raw = store.raw[s]
        n_local = int(raw.shape[0])
        m = int(min(128, n_local))
        ids = rng.choice(n_local, size=m, replace=False)
        db_q = np.asarray(raw[jnp.asarray(ids)])
        sigma = db_q.std(axis=0, keepdims=True)
        half = m // 2
        synth = db_q[:half] + rng.standard_normal(
            (half, db_q.shape[1])
        ).astype(np.float32) * sigma
        queries = np.concatenate([db_q[half:], synth], axis=0)
        bucket = 1 << max(6, (len(queries) - 1).bit_length())
        if bucket != len(queries):
            queries = np.concatenate(
                [queries, queries[-1:].repeat(bucket - len(queries), 0)]
            )
        neighbors = NeighborStore.pack(
            store.nbr_ids[s], store.nbr_planes[s], store.nbr_aux[s]
        )
        k_max = min(100, n_local)
        out = beam.search_batch(
            raw, store.norm_sq[s], neighbors, store.entry_candidates[s],
            signs, jnp.asarray(queries), params, bits=bits, k=k_max,
            beam_cap=max(2 * r, 4 * k_max), max_steps=512, n_seeds=4,
            debug_state=True,
        )
        res_step = np.asarray(out[2].res_step)
        for k_anchor in (10, 100):
            k_eff = min(k_anchor, k_max)
            present = res_step[:, :k_eff].max(axis=1)
            b = int(np.clip(np.ceil(np.quantile(present, 0.99)), 16, 512))
            budgets[k_anchor] = max(budgets[k_anchor], b)
    return budgets


class ShardedIndex:
    """User-facing facade over the sharded store: CPIndex semantics with
    the database partitioned over the mesh's "model" axis.

    Each shard builds an independent CP-HNSW subgraph; EVT-CRC calibration
    is pooled (median) over several shard subgraphs; a search runs
    per-chip DABS + the cross-chip all-gather top-k merge and returns ids
    in the caller's original vector order.
    """

    def __init__(self, dim: int, bits: int = 1, r: int = 32, seed: int = 42):
        from cphnsw_tpu.ops import hadamard

        self.dim = dim
        self.bits = bits
        self.r = r
        self.seed = seed
        self._padded = hadamard.next_pow2(dim)
        self._signs = hadamard.rotation_signs(seed, self._padded)
        self._store = None
        self._mesh = None
        self._params = None
        self._n = 0

    def build(self, vectors: np.ndarray, mesh: Mesh):
        self._n = len(vectors)
        n_model = mesh.shape["model"]
        store, _ = build_sharded_store(
            vectors, self.bits, self.r, n_model, self._signs, self.seed
        )
        self._params = _pooled_params(
            store, self._signs, self.bits, self.r, self._padded
        )
        self._step_budget = _derive_shard_step_budget(
            store, self._params, self._signs, self.bits, self.r, self.seed
        )
        self._store = shard_store(store, mesh)
        self._mesh = mesh
        return self

    def _max_steps(self, k: int) -> int:
        """Measured step budget (same recall-sufficient-step derivation as
        Index._derive_step_budget, run on shard subgraphs at build time),
        log-k interpolated between the k=10 and k=100 anchors."""
        sb = getattr(self, "_step_budget", None)
        if not sb:
            return 512
        s10, s100 = sb[10], sb[100]
        if k <= 10:
            need = s10
        elif k >= 100:
            need = s100
        else:
            need = s10 + (s100 - s10) * (np.log10(k) - 1.0)
        return int(np.clip(8 * np.ceil(need / 8.0), 16, 512))

    def search_batch(self, queries: np.ndarray, k: int = 10):
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        # pad the batch to the data-axis multiple; trim on return
        nq = len(queries)
        pad = (-nq) % self._mesh.shape["data"]
        q_in = queries
        if pad:
            q_in = np.concatenate(
                [queries, np.repeat(queries[-1:], pad, axis=0)]
            )
        ids, dists = sharded_search(
            self._store, jnp.asarray(q_in), self._params,
            self._signs, self._mesh, bits=self.bits, k=k,
            max_steps=self._max_steps(k), n_real=self._n,
        )
        return (
            np.asarray(ids)[:nq].astype(np.int64),
            np.asarray(dists)[:nq],
        )

    # ---------------------------------------------------------- persist
    def save(self, path):
        """Serialize the sharded store + pooled calibration (one npz).
        Mirrors Index.save's role for the sharded facade; the mesh itself
        is runtime state and is re-supplied at load."""
        import json

        if self._store is None:
            raise RuntimeError("ShardedIndex must be built before saving.")
        header = {
            "magic": "CPHNSW-TPU-SHARDED",
            "version": 1,
            "dim": self.dim,
            "bits": self.bits,
            "r": self.r,
            "seed": self.seed,
            "n": self._n,
            "step_budget": getattr(self, "_step_budget", None),
            "params": {
                f: np.asarray(getattr(self._params, f)).tolist()
                for f in self._params._fields
            },
        }
        arrays = {
            f: np.asarray(getattr(self._store, f))
            for f in ShardedStore._fields
        }
        np.savez_compressed(
            path,
            header=np.frombuffer(
                json.dumps(header).encode(), dtype=np.uint8
            ),
            **arrays,
        )

    def load(self, path, mesh: Mesh):
        import json

        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != "CPHNSW-TPU-SHARDED":
                raise ValueError("Not a sharded CPHNSW-TPU index file.")
            if (header["dim"], header["bits"], header["r"]) != (
                self.dim, self.bits, self.r
            ):
                raise ValueError("Index file dim/bits/R mismatch.")
            if header["seed"] != self.seed:
                raise ValueError("Index file rotation seed mismatch.")
            if int(z["raw"].shape[0]) != mesh.shape["model"]:
                raise ValueError(
                    f"Index file has {z['raw'].shape[0]} shards; mesh "
                    f"model axis is {mesh.shape['model']}."
                )
            store = ShardedStore(
                **{f: jnp.asarray(z[f]) for f in ShardedStore._fields}
            )
            pf = header["params"]
        self._n = header["n"]
        sb = header.get("step_budget")
        self._step_budget = (
            {int(kk): int(vv) for kk, vv in sb.items()} if sb else None
        )
        self._params = beam.SearchParams(
            **{
                f: (
                    jnp.int32(pf[f]) if f == "gamma_warmup"
                    else jnp.asarray(pf[f], jnp.float32)
                )
                for f in beam.SearchParams._fields
            }
        )
        self._store = shard_store(store, mesh)
        self._mesh = mesh
        return self
