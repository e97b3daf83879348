"""ScanIndex: the flat (graph-free) scan index facade.

Same public contract as CPIndex/Index (reference src/bindings.cpp:115-240:
build / finalize / search / search_batch / save / load / size / dim /
is_finalized, zero search-tuning parameters) over the full-database scan
engine in search/scan.py: one int8 contraction estimates every database
distance, a binned-min packed-key reduce selects candidates, and the
exact-L2 rerank matches the reference's
(search/rabitq_search.hpp:132-133).

Where the reference derives beam gates from EVT calibration, the scan's
single derived quantity is the candidate budget top_c(k): measured at
finalize() time as the tail quantile of the rank the true k-th neighbor
gets under the estimate ordering (search/scan.py::derive_candidate_budget)
— no user-facing knobs, preserving the calibration-parameterless contract.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.ops import hadamard, pack, quantize
from cphnsw_tpu.search import scan

MAGIC = "CPHNSW-TPU-SCAN"
VERSION = 2  # v2: codes stored as packed uint32 bit-planes (bits*P/8 B/vec)
ENCODE_CHUNK = 1 << 17  # rows per encode dispatch (bounds HBM intermediates)
# Queries are searched in fixed sub-batches: each sub-batch's scan is
# dispatched without a sync, so the host->device copy of sub-batch i+1
# and the device->host copy of sub-batch i (copy_to_host_async) overlap
# the scan of its neighbours.  Large candidate budgets shrink it further
# (scan.derived_sub_batch).
SEARCH_SUB_BATCH = 2048


@jax.jit
def _pack_pair(ids, dists):
    """(Q, k) ids + f32 dists -> one (2, Q, k) int32 array so each
    sub-batch's result crosses to the host as a single buffer."""
    return jnp.stack(
        [ids, jax.lax.bitcast_convert_type(dists, jnp.int32)], 0
    )


class ScanIndex:
    """Flat calibrated-scan index.  Constructor mirrors Index(dim, bits,
    metric); see module docstring."""

    def __init__(
        self,
        dim: int,
        bits: int = 1,
        rotation_seed: int = hadamard.DEFAULT_ROTATION_SEED,
        metric: str = "l2",
    ):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        self._dim = dim
        self._bits = bits
        self._seed = rotation_seed
        self._metric = metric
        self._ip_norm_bound = None
        self._inner_dim = dim + 1 if metric == "ip" else dim
        self._padded = hadamard.next_pow2(self._inner_dim)
        self._signs = hadamard.rotation_signs(rotation_seed, self._padded)

        self._n = 0
        self._finalized = False
        self._needs_build = False
        self._vectors_host = None

        # populated by finalize
        self._arrays: scan.ScanArrays | None = None
        self._centroid = None
        self._node_host = None  # dict of per-node np arrays (for save)
        self._affine_a = 1.0
        self._affine_b = 0.0
        self._ip_qo_floor = 0.0
        self._budget: scan.CandidateBudget | None = None
        # device-resident copies of the per-call scalars, staged once
        # so search_batch uploads only the queries
        self._dev_scalars = None

    # ------------------------------------------------------------- build
    def build(self, vectors):
        """Stage vectors (reference Index::build, hnsw_index.hpp:93-120;
        encoding is deferred to finalize so build+finalize timing matches
        the reference's split of cheap staging vs heavy finalize).

        Accepts a host np.ndarray OR a device-resident jax.Array — the
        device path skips the host->device upload entirely (stores
        generated or streamed on the device never cross to the host)."""
        if isinstance(vectors, jax.Array) and not isinstance(
            vectors, np.ndarray
        ):
            if vectors.ndim != 2 or vectors.shape[1] != self._dim:
                raise ValueError(
                    f"expected (n, {self._dim}) array, got {vectors.shape}"
                )
            if vectors.shape[0] == 0:
                raise ValueError("build requires at least one vector.")
            self._n = int(vectors.shape[0])
            vecs_d = vectors.astype(jnp.float32)
            if self._metric == "ip":
                # deliberately f32 (x64 is disabled by default; a float64
                # astype would silently truncate) with the bound inflated
                # by a relative epsilon so max(bound - norms, 0) never
                # clips a genuine row to zero augmentation the way f32
                # rounding of the max row could
                norms_sq = jnp.sum(vecs_d * vecs_d, axis=1)
                bound_sq = float(jnp.max(norms_sq)) * (1.0 + 1e-6)
                self._ip_norm_bound = bound_sq
                aug = jnp.sqrt(
                    jnp.maximum(bound_sq - norms_sq, 0.0)
                ).astype(jnp.float32)
                vecs_d = jnp.concatenate([vecs_d, aug[:, None]], axis=1)
            self._vectors_dev = vecs_d
            self._vectors_host = None
            self._finalized = False
            self._needs_build = True
            return self
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"expected (n, {self._dim}) float32 array, got {vectors.shape}"
            )
        if len(vectors) == 0:
            raise ValueError("build requires at least one vector.")
        self._n = len(vectors)
        if self._metric == "ip":
            norms_sq = (vectors.astype(np.float64) ** 2).sum(1)
            bound_sq = float(norms_sq.max())
            self._ip_norm_bound = bound_sq
            aug = np.sqrt(np.maximum(bound_sq - norms_sq, 0.0))
            vectors = np.concatenate(
                [vectors, aug[:, None].astype(np.float32)], axis=1
            )
        self._vectors_host = vectors
        self._vectors_dev = None
        self._finalized = False
        self._needs_build = True
        return self

    def finalize(self, verbose: bool = False):
        """Encode + calibrate + derive the candidate budget.

        Per-stage wall times land in self.build_stages (seconds) so a
        slow build stage is diagnosable from the results JSON rather
        than verbose prints."""
        import time as _time

        stages: dict[str, float] = {}
        t_last = _time.perf_counter()

        def _mark(name):
            nonlocal t_last
            now = _time.perf_counter()
            stages[name] = round(now - t_last, 2)
            t_last = now

        if self._n == 0:
            raise RuntimeError("Cannot finalize an empty index.")
        if not self._needs_build:
            raise RuntimeError("Finalize called without a pending build.")
        n = self._n
        n_pad = scan.store_pad(n)
        if getattr(self, "_vectors_dev", None) is not None:
            vecs_d = self._vectors_dev
        else:
            vecs_d = jnp.asarray(self._vectors_host)
        # one fused program pads rows+dims and computes norms WITHOUT
        # materializing intermediate padded copies (the eager
        # pad->pad->square chain holds two extra store-sized copies)
        raw, norm_sq = scan.pad_store_and_norms(
            vecs_d, rows=n_pad, cols=self._padded
        )
        jax.block_until_ready(norm_sq)
        # drop the unpadded staging copy NOW: at 10M x 96d it is 3.8 GB
        # that need not live alongside raw + the encode intermediates
        self._vectors_dev = None
        self._vectors_host = None
        del vecs_d
        centroid = quantize.compute_centroid(raw[:n])
        kappa = float((1 << self._bits) - 1)
        planes, nop, ip_qo, ip_cp, wpc = scan.encode_scan_store(
            raw, centroid, self._signs, self._bits, chunk=ENCODE_CHUNK
        )
        jax.block_until_ready(nop)
        _mark("encode")

        a, b, floor = scan.calibrate_scan_affine(
            raw, planes, nop, ip_qo, ip_cp, wpc, centroid, self._signs,
            n, self._bits, seed=self._seed + 99999,
        )
        node_aux = scan.fold_node_constants(
            nop, ip_qo, ip_cp, wpc, jnp.asarray(floor, jnp.float32),
            jnp.asarray(n),
        )
        _mark("calibrate")
        arrays = scan.ScanArrays(
            planes=planes, node_aux=node_aux, raw=raw, norm_sq=norm_sq
        )
        budget = scan.derive_candidate_budget(
            arrays, self._signs, a, b, n, kappa, seed=self._seed + 4242
        )
        _mark("candidate_budget")
        if verbose:
            print(
                f"scan budget anchors={budget.anchors.tolist()} "
                f"ranks={budget.ranks.tolist()} affine=({a:.4f},{b:.4f})",
                flush=True,
            )

        self._node_host = dict(
            nop=np.asarray(nop), ip_qo=np.asarray(ip_qo),
            ip_cp=np.asarray(ip_cp), wpc=np.asarray(wpc),
            planes=np.asarray(planes),
        )
        self._arrays = arrays
        self._centroid = centroid
        self._affine_a, self._affine_b, self._ip_qo_floor = a, b, floor
        self._budget = budget
        self._stage_scalars()
        self._vectors_host = None
        self._vectors_dev = None
        self._needs_build = False
        self._finalized = True
        self._sketch = None  # lazy rerank sketch; invalidated per build
        _mark("stage_host_copies")
        self.build_stages = stages
        return self

    def _use_fused(self) -> bool:
        """The Pallas scan+select kernel runs compiled on the GPU (the
        sketch-scan mode of search_plan); the XLA chunked path runs
        everywhere else."""
        if not hasattr(self, "_fused"):
            self._fused = scan.use_kernel()
        return self._fused

    def _stage_scalars(self):
        self._dev_scalars = (
            jnp.asarray(self._affine_a, jnp.float32),
            jnp.asarray(self._affine_b, jnp.float32),
            jnp.asarray(self._n),
        )

    # ------------------------------------------------------------ search
    def search_plan(self, k: int) -> dict:
        """The derived plan a k-NN search runs: the candidate budget
        top_c, the selection mode, whether the scan+select kernel runs,
        and the query sub-batch.

        Modes: "sketch-scan" (kernel path: the int8 sketch of the raw
        store streams through the kernel, its survivors get the exact
        rerank), "two-stage-gather" (XLA path, top_c >= TWO_STAGE_MIN_C:
        estimate-select, then a reduced-precision sketch pass over the
        gathered candidates picks the exact-rerank survivors) and
        "estimate-select" (estimate-select, exact rerank).  The
        sub-batch follows the selection width (scan.derived_sub_batch),
        so large candidate budgets shrink it."""
        if not self._finalized:
            raise RuntimeError("Index must be finalized before searching.")
        k_eff = min(max(int(k), 1), self._n)
        top_c = self._budget.top_c(k_eff, self._n)
        kernel = self._use_fused()
        width = top_c
        if kernel:
            mode = "sketch-scan"
            width = scan._rerank_survivors(k_eff, top_c)
        elif top_c >= scan.TWO_STAGE_MIN_C:
            mode = "two-stage-gather"
        else:
            mode = "estimate-select"
        return dict(
            k=k_eff, top_c=top_c, mode=mode, kernel=kernel,
            sub_batch=scan.derived_sub_batch(
                self._arrays.raw.shape[0], width, cap=SEARCH_SUB_BATCH
            ),
        )

    def search_batch(self, queries: np.ndarray, k: int = 10):
        """Batch search; returns (ids (Q,k) int64, dists (Q,k) f32 squared
        L2, or scores for metric='ip')."""
        if not self._finalized:
            raise RuntimeError("Index must be finalized before searching.")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._dim:
            raise ValueError(
                f"expected (q, {self._dim}) float32 queries, got "
                f"{queries.shape}"
            )
        k = max(int(k), 1)
        k_eff = min(k, self._n)
        if self._metric == "ip":
            queries = np.concatenate(
                [queries, np.zeros((len(queries), 1), np.float32)], axis=1
            )

        nq = len(queries)
        n_pad = self._arrays.raw.shape[0]
        search_plan = self.search_plan(k_eff)
        top_c_k = search_plan["top_c"]
        aff_a, aff_b, n_dev = self._dev_scalars
        # the sketch store is created lazily the first time a search's
        # mode needs it, never for small-budget indexes
        sketch = None
        if search_plan["mode"] != "estimate-select":
            need_int8 = search_plan["mode"] == "sketch-scan"
            cached = self._sketch
            if cached is None or (need_int8 and cached.scale is None):
                self._sketch = scan.make_rerank_sketch(
                    self._arrays.raw, self._arrays.norm_sq,
                    force_int8=need_int8,
                )
            sketch = self._sketch
        # Sub-batch plan: full sub-batch slices, then the tail rounded up
        # to its own power-of-two bucket (>= 64) instead of a full extra
        # sub-batch — nq=2049 costs one 2048 scan + one 64 scan, not two
        # 2048 scans (the jit cache holds one program per bucket size, a
        # bounded grid).
        sub_batch = search_plan["sub_batch"]
        plan = []  # (start, rows, padded_rows)
        s = 0
        while s < nq:
            rem_q = nq - s
            if rem_q >= sub_batch:
                plan.append((s, sub_batch, sub_batch))
                s += sub_batch
            else:
                bucket = min(
                    1 << max(6, (rem_q - 1).bit_length()), sub_batch
                )
                plan.append((s, rem_q, bucket))
                s = nq
        # dispatch every sub-batch without syncing: upload(i+1) overlaps
        # scan(i) on the device, and each sub-batch's packed result starts
        # its device->host copy (copy_to_host_async) as soon as its scan
        # is dispatched instead of serializing at the end
        packs = []
        for start, rows, padded in plan:
            q_sub = queries[start:start + rows]
            if padded != rows:
                q_sub = np.concatenate(
                    [q_sub, np.repeat(q_sub[-1:], padded - rows, axis=0)]
                )
            chunk, n_eq, rem = scan.chunk_plan(n_pad, padded)
            top_c = max(min(top_c_k, chunk), k_eff)
            q_dev = jax.device_put(q_sub)
            ids_d, d_d = scan.scan_search(
                self._arrays, q_dev, self._signs, aff_a, aff_b, n_dev,
                kappa=float((1 << self._bits) - 1),
                k=k_eff, top_c=top_c, chunk=chunk, n_eq=n_eq, rem=rem,
                fused=search_plan["kernel"], sketch=sketch,
            )
            p = _pack_pair(ids_d, d_d)
            try:
                p.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass  # backends without async host copies fetch below
            packs.append((p, rows))
        ids_l, dists_l = [], []
        for p, rows in packs:
            arr = np.asarray(p)
            ids_l.append(arr[0, :rows])
            dists_l.append(arr[1, :rows])
        ids = np.concatenate(ids_l).astype(np.int64)
        dists = np.concatenate(dists_l).view(np.float32)
        if self._metric == "ip":
            qn = (queries[:nq, : self._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(
                dists < np.finfo(np.float32).max,
                (qn + self._ip_norm_bound - dists) / 2.0,
                -np.inf,
            ).astype(np.float32)
        if k_eff < k:
            pad_i = np.full((nq, k - k_eff), -1, np.int64)
            pad_val = (
                -np.inf if self._metric == "ip" else np.finfo(np.float32).max
            )
            pad_d = np.full((nq, k - k_eff), pad_val, np.float32)
            ids = np.concatenate([ids, pad_i], axis=1)
            dists = np.concatenate([dists, pad_d], axis=1)
        return ids, dists

    def search(self, query: np.ndarray, k: int = 10):
        query = np.ascontiguousarray(query, dtype=np.float32)
        ids, dists = self.search_batch(query[None, :], k)
        return ids[0], dists[0]

    # ------------------------------------------------------------- state
    @property
    def size(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def is_finalized(self) -> bool:
        return self._finalized

    # ------------------------------------------------------------ persist
    def save(self, path: str | Path):
        """Serialize (scan-mode analog of Index::save,
        hnsw_index.hpp:217-303): header JSON + arrays in one npz."""
        if not self._finalized:
            raise RuntimeError("Index must be finalized before saving.")
        header = {
            "magic": MAGIC,
            "version": VERSION,
            "dim": self._dim,
            "padded": self._padded,
            "bits": self._bits,
            "n": self._n,
            "rotation_seed": self._seed,
            "metric": self._metric,
            "ip_norm_bound": self._ip_norm_bound,
            "affine_a": self._affine_a,
            "affine_b": self._affine_b,
            "ip_qo_floor": self._ip_qo_floor,
            "budget_anchors": self._budget.anchors.tolist(),
            "budget_ranks": self._budget.ranks.tolist(),
        }
        np.savez_compressed(
            path,
            header=np.frombuffer(
                json.dumps(header).encode(), dtype=np.uint8
            ),
            raw=np.asarray(self._arrays.raw),
            centroid=np.asarray(self._centroid),
            **self._node_host,
        )

    def _load_host(self, path: str | Path):
        """Parse + validate a saved index entirely HOST-side (no device
        staging): returns (header, node_host, raw_h, centroid_h).  The
        single-chip load stages the result onto the default device; the
        sharded load slices it per shard and places each slice on its own
        mesh device, so the full store never lands on one chip."""
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError("Not a CPHNSW-TPU scan index file.")
            if header.get("version") != VERSION:
                raise ValueError(
                    f"Unsupported scan index version {header.get('version')}"
                )
            if header["dim"] != self._dim:
                raise ValueError(
                    f"Index file dim={header['dim']} mismatches dim="
                    f"{self._dim}"
                )
            if header["bits"] != self._bits:
                raise ValueError("Index file bits parameter mismatch.")
            if header["rotation_seed"] != self._seed:
                raise ValueError("Index file rotation seed mismatch.")
            if header["metric"] != self._metric:
                raise ValueError(
                    f"Index file metric={header['metric']!r} mismatches "
                    f"constructor metric={self._metric!r}"
                )
            node_host = dict(
                nop=np.asarray(z["nop"]), ip_qo=np.asarray(z["ip_qo"]),
                ip_cp=np.asarray(z["ip_cp"]), wpc=np.asarray(z["wpc"]),
                planes=np.asarray(z["planes"]),
            )
            raw_h = np.asarray(z["raw"])
            centroid_h = np.asarray(z["centroid"])
        return header, node_host, raw_h, centroid_h

    def _apply_header(self, header):
        """Commit the scalar fields of a validated header."""
        self._n = header["n"]
        if header["padded"] != self._padded:
            self._padded = header["padded"]
            self._signs = hadamard.rotation_signs(self._seed, self._padded)
        self._ip_norm_bound = header.get("ip_norm_bound")
        self._affine_a = float(header["affine_a"])
        self._affine_b = float(header["affine_b"])
        self._ip_qo_floor = float(header["ip_qo_floor"])
        self._budget = scan.CandidateBudget(
            anchors=np.asarray(header["budget_anchors"], np.int64),
            ranks=np.asarray(header["budget_ranks"], np.int64),
        )
        return self

    def load(self, path: str | Path):
        """Restore; validates magic/version/dim/bits/metric/seed, commits
        atomically (reference Index::load, hnsw_index.hpp:305-443)."""
        header, node_host, raw_h, centroid_h = self._load_host(path)
        self._apply_header(header)
        self._node_host = node_host
        # norms from the same program finalize() ran, so a reloaded
        # index returns bit-identical distances
        raw, norm_sq = scan.pad_store_and_norms(
            jnp.asarray(raw_h), rows=raw_h.shape[0], cols=raw_h.shape[1]
        )
        node_aux = scan.fold_node_constants(
            jnp.asarray(node_host["nop"]), jnp.asarray(node_host["ip_qo"]),
            jnp.asarray(node_host["ip_cp"]), jnp.asarray(node_host["wpc"]),
            jnp.asarray(self._ip_qo_floor, jnp.float32),
            jnp.asarray(self._n),
        )
        self._arrays = scan.ScanArrays(
            planes=jnp.asarray(node_host["planes"]),
            node_aux=node_aux,
            raw=raw,
            norm_sq=norm_sq,
        )
        self._centroid = jnp.asarray(centroid_h)
        self._stage_scalars()
        self._sketch = None
        self._finalized = True
        self._needs_build = False
        return self
