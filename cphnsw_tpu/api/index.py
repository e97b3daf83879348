"""Index facade: the calibration-parameterless public API.

Accelerator re-expression of Index / CPIndex
(/root/reference/include/cphnsw/api/hnsw_index.hpp:67-1140 and
/root/reference/src/bindings.cpp:115-240):

  * `CPIndex(dim, bits)` with build / finalize / search / search_batch /
    save / load / size / dim / is_finalized — and ZERO search-tuning
    parameters: everything is derived at finalize() time by the graph
    statistics and EVT-CRC calibration pipeline.
  * The reference's compile-time template dispatch over padded dims
    (src/bindings.cpp:77-113) is unnecessary here: shapes are runtime
    values that jit specializes on.
  * Unlike the reference, search results are mapped back to the caller's
    original vector indices (the reference returns BFS-reordered internal
    ids, hnsw_index.hpp:139-159 — an apparent contract bug its own harness
    inherits).

Entry strategy: hub entry point + direct DABS at layer 0 (SURVEY.md
section 7, "Option B"); the hierarchical HNSW upper layers exist in
api/upper_layers.py and are enabled by default for parity ("Option A") —
they supply a per-query entry for layer 0.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.calibration import calibrate as calib_mod
from cphnsw_tpu.graph import build as gbuild
from cphnsw_tpu.graph.build import NeighborStore
from cphnsw_tpu.ops import hadamard, quantize
from cphnsw_tpu.search import beam

MAGIC = "CPHNSW-TPU"
VERSION = 3
DEFAULT_R = 32  # reference fixes R=32 in the bindings (src/bindings.cpp:42)


class Index:
    """Builder + searcher for one dataset.  See module docstring."""

    def __init__(
        self,
        dim: int,
        bits: int = 1,
        r: int = DEFAULT_R,
        rotation_seed: int = hadamard.DEFAULT_ROTATION_SEED,
        entry_strategy: str = "seed",
        metric: str = "l2",
    ):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if entry_strategy not in ("seed", "hnsw"):
            raise ValueError("entry_strategy must be 'seed' or 'hnsw'")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        # Inner-product metric (reference is L2-only; BASELINE.json lists
        # IP as an extension): MIPS reduces to L2 through the standard
        # augmentation x' = [x, sqrt(M^2 - |x|^2)], q' = [q, 0]; argmax
        # <q, x> == argmin |q' - x'|^2.  The EVT-CRC calibration then runs
        # unchanged on the augmented space.
        self._metric = metric
        self._ip_norm_bound = None
        self._entry_strategy = entry_strategy
        self._upper = None
        # beam entries expanded per search step: >1 trades a few wasted
        # expansions for proportionally fewer (serial) while_loop steps —
        # a win wherever each step is latency-bound
        self._expand_width = 4
        self._dim = dim
        self._bits = bits
        self._r = r
        self._seed = rotation_seed
        self._inner_dim = dim + 1 if metric == "ip" else dim
        self._padded = hadamard.next_pow2(self._inner_dim)
        self._signs = hadamard.rotation_signs(rotation_seed, self._padded)

        self._finalized = False
        self._needs_build = False
        self._n = 0

        # populated by build/finalize
        self._raw = None          # (N, P) device, BFS order after finalize
        self._norm_sq = None
        self._node_nop = None
        self._centroid = None
        self._neighbors: NeighborStore | None = None
        self._entry = 0
        self._new_to_old = None   # (N,) int64
        self._profile: calib_mod.IndexProfile | None = None
        self._snapshot: calib_mod.CalibrationSnapshot | None = None
        self._params: beam.SearchParams | None = None
        self._stats = None

    # ------------------------------------------------------------- build
    def build(self, vectors: np.ndarray):
        """Encode + stage vectors (reference Index::build,
        hnsw_index.hpp:93-120)."""
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
        raw = hadamard.pad_to(jnp.asarray(vectors), self._padded)
        self._raw = raw
        self._norm_sq = jnp.sum(raw * raw, axis=-1)
        self._centroid = quantize.compute_centroid(raw)
        self._node_nop = jnp.linalg.norm(raw - self._centroid, axis=-1)
        self._finalized = False
        self._needs_build = True
        return self

    def finalize(self, verbose: bool = False):
        """Graph construction + calibration (reference Index::finalize,
        hnsw_index.hpp:122-166)."""
        if self._n == 0:
            raise RuntimeError("Cannot finalize an empty index.")
        if not self._needs_build:
            raise RuntimeError("Finalize called without a pending build.")

        self._profile = calib_mod.IndexProfile.derive(
            self._n, self._padded, self._r, self._bits
        )

        res = gbuild.build_graph(
            self._raw, self._norm_sq, self._node_nop, self._signs,
            bits=self._bits, r=self._r, seed=self._seed, verbose=verbose,
        )
        self._raw = res.raw
        self._norm_sq = res.norm_sq
        self._node_nop = res.node_nop
        self._neighbors = res.neighbors
        self._entry = res.entry_point
        self._stats = res.stats
        self._entry_candidates = self._make_entry_candidates()
        if self._entry_strategy == "hnsw":
            from cphnsw_tpu.api import upper_layers as ul

            self._upper = ul.build_upper_layers(
                self._raw, self._norm_sq, self._r, seed=self._seed
            )
        n2o = np.empty(self._n, np.int64)
        n2o[res.old_to_new] = np.arange(self._n)
        self._new_to_old = n2o

        self._snapshot = calib_mod.calibrate(
            self._raw, self._norm_sq, self._neighbors, self._signs,
            self._bits, self._profile, seed=self._seed + 99999,
            verbose=verbose,
        )
        self._params = calib_mod.to_search_params(self._snapshot)
        self._derive_step_budget(verbose=verbose)

        self._needs_build = False
        self._finalized = True
        return self

    # ------------------------------------------------------------ search
    def _require_finalized(self):
        if not self._finalized:
            raise RuntimeError("Index must be finalized before searching.")

    def search_batch(self, queries: np.ndarray, k: int = 10):
        """Batch search (reference CPIndex::search_batch,
        src/bindings.cpp:177-218).  Returns (ids (Q,k) int64 in the
        caller's original vector order, dists (Q,k) f32 squared L2)."""
        self._require_finalized()
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

        entry = self._entry_candidates
        if self._entry_strategy == "hnsw" and self._upper is not None:
            from cphnsw_tpu.api import upper_layers as ul

            qpad = jnp.asarray(
                np.pad(queries, [(0, 0), (0, self._padded - queries.shape[1])])
            )
            qnorm = jnp.sum(qpad * qpad, -1)
            entry = ul.greedy_descend(
                self._upper, self._raw, self._norm_sq, qpad, qnorm
            )

        # pad the query batch to a power-of-two row count so jit compiles
        # once per bucket instead of once per caller batch size
        nq = len(queries)
        bucket = 1 << max(6, (nq - 1).bit_length())
        q_in = queries
        if bucket != nq:
            q_in = np.concatenate(
                [queries, np.repeat(queries[-1:], bucket - nq, axis=0)]
            )
            if isinstance(entry, jnp.ndarray) and entry.ndim == 2:
                entry = jnp.concatenate(
                    [entry, jnp.repeat(entry[-1:], bucket - nq, axis=0)]
                )

        ids, dists = beam.search_batch(
            self._raw, self._norm_sq, self._neighbors,
            entry, self._signs,
            jnp.asarray(q_in), self._params,
            bits=self._bits, k=k_eff,
            beam_cap=max(2 * self._r, 4 * k_eff),
            max_steps=self._max_steps(k_eff),
            expand_width=self._expand_width,
            visited_hash_bits=self._visited_hash_bits(),
        )
        ids = np.asarray(ids)[:nq]
        dists = np.asarray(dists)[:nq]
        if self._metric == "ip":
            # |q'-x'|^2 = |q|^2 + M^2 - 2<q,x>  ->  <q,x>
            qn = (queries[:nq, : self._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(
                dists < np.finfo(np.float32).max,
                (qn + self._ip_norm_bound - dists) / 2.0,
                -np.inf,
            ).astype(np.float32)
        mapped = np.where(ids >= 0, self._new_to_old[np.maximum(ids, 0)], -1)
        if k_eff < k:  # pad like the reference bindings (-1 / FLT_MAX);
            # ip scores are larger-is-better, so their invalid slots use
            # -inf to keep pad entries ranked last under either convention
            pad_i = np.full((len(queries), k - k_eff), -1, np.int64)
            pad_val = (
                -np.inf if self._metric == "ip" else np.finfo(np.float32).max
            )
            pad_d = np.full((len(queries), k - k_eff), pad_val, np.float32)
            mapped = np.concatenate([mapped, pad_i], axis=1)
            dists = np.concatenate([dists, pad_d], axis=1)
        return mapped.astype(np.int64), dists

    def search(self, query: np.ndarray, k: int = 10):
        query = np.ascontiguousarray(query, dtype=np.float32)
        ids, dists = self.search_batch(query[None, :], k)
        return ids[0], dists[0]

    def _make_entry_candidates(self):
        """Hub entry + a fixed uniform sample: the seed-scan pool for
        beam.search_batch (one exact matmul per query batch)."""
        m = int(min(self._n, max(64, 4 * np.sqrt(self._n))))
        rng = np.random.default_rng(self._seed + 7)
        cand = rng.choice(self._n, size=m, replace=False)
        cand = np.unique(np.concatenate([[self._entry], cand]))
        return jnp.asarray(cand.astype(np.int32))

    def _visited_hash_bits(self) -> int:
        # Hash-table visited dedup above 50k nodes, table size scaling
        # with n like the reference's visitation_headroom = clamp(n/4,
        # 256, n) (core/adaptive_defaults.hpp:80-82); capped at 2^18
        # slots (1 MB/query).
        if self._n < 50_000:
            return 0
        return int(np.clip(np.ceil(np.log2(self._n / 4)), 13, 18))

    def _derive_step_budget(self, verbose: bool = False):
        """Measure the step budget from this index's own data: ONE
        generously-capped k=100 run over calibration-style queries
        (database rows + jittered synthetics, the recipe of
        calibrate_estimator's query set, hnsw_index.hpp:873-890), whose
        per-result insertion steps (BeamState.res_step) yield, for every
        anchor k' <= 100 at once, the first step at which each query's
        FINAL top-k' was already present.  The budget at an anchor is the
        99th-percentile of that recall-sufficient step — not the last
        result change, which keeps moving long after the final top-k' is
        assembled and over-budgets the search (measured: 0.63x QPS at
        identical recall).  Two anchors (10, 100) interpolate query-time
        budgets with zero workload-tuned constants (the "zero search
        parameters" contract, reference README)."""
        rng = np.random.default_rng(self._seed + 4242)
        m = int(min(256, self._n))
        ids = rng.choice(self._n, size=m, replace=False)
        db_q = np.asarray(self._raw[jnp.asarray(ids)])
        sigma = db_q.std(axis=0, keepdims=True)
        half = m // 2
        synth = db_q[:half] + rng.standard_normal(
            (half, db_q.shape[1])
        ).astype(np.float32) * sigma
        queries = np.concatenate([db_q[half:], synth], axis=0)
        # pad to the jit bucket grid (power of two, >= 64)
        bucket = 1 << max(6, (len(queries) - 1).bit_length())
        if bucket != len(queries):
            queries = np.concatenate(
                [queries, queries[-1:].repeat(bucket - len(queries), 0)]
            )

        cap = 512
        k_max = min(100, self._n)
        out = beam.search_batch(
            self._raw, self._norm_sq, self._neighbors,
            self._entry_candidates, self._signs,
            jnp.asarray(queries), self._params,
            bits=self._bits, k=k_max,
            beam_cap=max(2 * self._r, 4 * k_max),
            max_steps=cap,
            expand_width=self._expand_width,
            visited_hash_bits=self._visited_hash_bits(),
            debug_state=True,
        )
        res_step = np.asarray(out[2].res_step)
        budgets = {}
        for k_anchor in (10, 100):
            k_eff = min(k_anchor, k_max)
            present = res_step[:, :k_eff].max(axis=1)
            budget = int(np.ceil(np.quantile(present, 0.99)))
            budgets[k_anchor] = int(np.clip(budget, 16, cap))
            if verbose:
                print(
                    f"step budget k={k_anchor}: topk-present "
                    f"p50={np.quantile(present, .5):.0f} "
                    f"p99={np.quantile(present, .99):.0f} -> "
                    f"{budgets[k_anchor]}",
                    flush=True,
                )
        self._step_budget = budgets

    def _max_steps(self, k: int = 10) -> int:
        """Budget for a k-NN search: log-k interpolation between the two
        measured anchors, rounded up to a multiple of 8 for jit-cache
        reuse.  Falls back to a dimension-free heuristic for legacy
        snapshots without measured budgets."""
        sb = getattr(self, "_step_budget", None)
        if not sb:
            ew = max(self._expand_width, 1)
            coef = 12.0 if self._n < 300_000 else 20.0
            need = coef * np.log2(max(self._n, 2)) * (4.0 / ew) / 4.0
            return int(np.clip(need, 40, 512))
        s10, s100 = sb[10], sb[100]
        if k <= 10:
            need = s10
        elif k >= 100:
            need = s100
        else:
            t = (np.log10(k) - 1.0)  # log10(k/10) over one decade
            need = s10 + (s100 - s10) * t
        return int(np.clip(8 * np.ceil(need / 8.0), 16, 512))

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
        """Serialize the finalized index (reference Index::save,
        hnsw_index.hpp:217-303): a header JSON (magic/version/params/seed +
        calibration + profile snapshots) plus all device arrays, in one npz.
        """
        self._require_finalized()
        header = {
            "magic": MAGIC,
            "version": VERSION,
            "dim": self._dim,
            "padded": self._padded,
            "bits": self._bits,
            "r": self._r,
            "n": self._n,
            "rotation_seed": self._seed,
            "entry_point": self._entry,
            "metric": self._metric,
            "ip_norm_bound": self._ip_norm_bound,
            "entry_strategy": self._entry_strategy,
            "upper_levels": 0 if self._upper is None
            else len(self._upper.node_ids),
            "upper_entry": None if self._upper is None
            else int(self._upper.entry_global),
            "step_budget": getattr(self, "_step_budget", None),
            "calibration": self._snapshot.to_dict(),
            "profile": self._profile.to_dict(),
            "graph_stats": self._stats.to_dict() if self._stats else None,
        }
        def _jsonable(o):
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            if isinstance(o, np.ndarray):
                return o.tolist()
            raise TypeError(f"not jsonable: {type(o)}")

        arrays = dict(
            raw=np.asarray(self._raw),
            norm_sq=np.asarray(self._norm_sq),
            node_nop=np.asarray(self._node_nop),
            centroid=np.asarray(self._centroid),
            new_to_old=self._new_to_old,
            entry_candidates=np.asarray(self._entry_candidates),
            nbr_ids=np.asarray(self._neighbors.ids),
            nbr_planes=np.asarray(self._neighbors.planes),
            nbr_aux=np.asarray(self._neighbors.aux),
        )
        if self._upper is not None:
            for i in range(len(self._upper.node_ids)):
                arrays[f"upper_ids_{i}"] = np.asarray(self._upper.node_ids[i])
                arrays[f"upper_nbr_{i}"] = np.asarray(self._upper.nbr_idx[i])
                arrays[f"upper_lm_{i}"] = np.asarray(
                    self._upper.local_of_global[i]
                )
        np.savez_compressed(
            path,
            header=np.frombuffer(
                json.dumps(header, default=_jsonable).encode(), dtype=np.uint8
            ),
            **arrays,
        )

    def load(self, path: str | Path):
        """Restore a saved index (reference Index::load,
        hnsw_index.hpp:305-443); validates magic/version/dim/bits/R and the
        rotation seed, then commits atomically."""
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError("Not a CPHNSW-TPU index file.")
            if header.get("version") != VERSION:
                raise ValueError(
                    f"Unsupported index file version {header.get('version')}"
                )
            if header["dim"] != self._dim:
                raise ValueError(
                    f"Index file dim={header['dim']} mismatches dim="
                    f"{self._dim}"
                )
            if header["bits"] != self._bits or header["r"] != self._r:
                raise ValueError("Index file bits/R parameters mismatch.")
            if header["rotation_seed"] != self._seed:
                raise ValueError("Index file rotation seed mismatch.")
            if header["metric"] != self._metric:
                raise ValueError(
                    f"Index file metric={header['metric']!r} mismatches "
                    f"constructor metric={self._metric!r}"
                )

            neighbors = NeighborStore.pack(
                jnp.asarray(z["nbr_ids"]),
                jnp.asarray(z["nbr_planes"]),
                jnp.asarray(z["nbr_aux"]),
            )
            raw = jnp.asarray(z["raw"])
            norm_sq = jnp.asarray(z["norm_sq"])
            node_nop = jnp.asarray(z["node_nop"])
            centroid = jnp.asarray(z["centroid"])
            new_to_old = np.asarray(z["new_to_old"])
            entry_candidates = jnp.asarray(z["entry_candidates"])
            upper = None
            if header.get("upper_levels", 0) > 0:
                from cphnsw_tpu.api import upper_layers as ul

                lv = header["upper_levels"]
                upper = ul.UpperLayers(
                    node_ids=tuple(
                        jnp.asarray(z[f"upper_ids_{i}"]) for i in range(lv)
                    ),
                    nbr_idx=tuple(
                        jnp.asarray(z[f"upper_nbr_{i}"]) for i in range(lv)
                    ),
                    local_of_global=tuple(
                        jnp.asarray(z[f"upper_lm_{i}"]) for i in range(lv)
                    ),
                    entry_global=int(header["upper_entry"]),
                )

        # all reads succeeded -> commit
        self._n = header["n"]
        if header["padded"] != self._padded:
            # regenerate the rotation for the file's padded dim (same seed)
            self._padded = header["padded"]
            self._signs = hadamard.rotation_signs(self._seed, self._padded)
        self._entry = header["entry_point"]
        self._ip_norm_bound = header.get("ip_norm_bound")
        self._entry_strategy = header.get("entry_strategy", "seed")
        sb = header.get("step_budget")
        self._step_budget = (
            {int(kk): int(vv) for kk, vv in sb.items()} if sb else None
        )
        self._upper = upper
        gs = header.get("graph_stats")
        if gs is not None:
            from cphnsw_tpu.graph import stats as gstats

            self._stats = gstats.GraphStats.from_dict(gs)
        self._neighbors = neighbors
        self._raw = raw
        self._norm_sq = norm_sq
        self._node_nop = node_nop
        self._centroid = centroid
        self._new_to_old = new_to_old
        self._entry_candidates = entry_candidates
        self._snapshot = calib_mod.CalibrationSnapshot.from_dict(
            header["calibration"]
        )
        self._profile = calib_mod.IndexProfile.from_dict(header["profile"])
        self._params = calib_mod.to_search_params(self._snapshot)
        self._finalized = True
        self._needs_build = False
        return self


# Engine choice: auto always takes the scan.  The graph store (raw 4P +
# R neighbor blocks ~ R*bits*P/8 + aux) is ~2.4x LARGER per row than the
# scan store (raw 4P + int8 sketch P + packed planes bits*P/8), so no
# store that is too big for the scan fits the graph, and the lockstep
# beam search is work-bound where the scan is one streamed contraction.
# Beyond one device the scan shards (ShardedScanIndex).  The graph engine
# stays available explicitly (engine="graph") as the reference-parity
# DABS implementation and via ShardedIndex.


class CPIndex:
    """Drop-in equivalent of the reference Python class `cphnsw.CPIndex`
    (src/bindings.cpp:115-240) — one class, zero search-tuning knobs.

    The engine behind it is derived, not configured (the reference's
    calibration-parameterless contract extended to the engine choice):
    `build()` picks the full-database scan (api/scan_index.py; see the
    engine-choice note above).  `engine="scan"|"graph"` overrides;
    `load()` detects the engine from the file header.
    """

    _ENGINES = ("auto", "scan", "graph")

    def __init__(
        self,
        dim: int,
        bits: int = 1,
        engine: str = "auto",
        metric: str = "l2",
    ):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if engine not in self._ENGINES:
            raise ValueError(f"engine must be one of {self._ENGINES}")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        self._dim = dim
        self._bits = bits
        self._engine_req = engine
        self._metric = metric
        self._index = None

    def _make_engine(self, name: str):
        if name == "scan":
            from cphnsw_tpu.api.scan_index import ScanIndex

            return ScanIndex(self._dim, self._bits, metric=self._metric)
        return Index(self._dim, self._bits, metric=self._metric)

    @property
    def engine(self) -> str:
        """The resolved engine name ('scan' or 'graph'), None before
        build/load."""
        if self._index is None:
            return None
        return "graph" if isinstance(self._index, Index) else "scan"

    def build(self, vectors):
        import jax

        if not isinstance(vectors, jax.Array):
            vectors = np.asarray(vectors)
        name = self._engine_req
        if name == "auto":
            # the scan engine at every single-device scale (see the
            # engine-choice note above)
            name = "scan"
        if self.engine != name:
            self._index = self._make_engine(name)
        if name == "graph" and isinstance(vectors, jax.Array):
            vectors = np.asarray(vectors)  # graph build stages on host
        self._index.build(vectors)

    def finalize(self):
        if self._index is None:
            raise RuntimeError("Finalize called without a pending build.")
        self._index.finalize()

    def search(self, query, k: int = 10):
        self._require_index()
        ids, dists = self._index.search(np.asarray(query), k)
        return ids.astype(np.int64), dists.astype(np.float32)

    def search_batch(self, queries, k: int = 10):
        self._require_index()
        ids, dists = self._index.search_batch(np.asarray(queries), k)
        return ids.astype(np.int64), dists.astype(np.float32)

    def save(self, path: str):
        self._require_index()
        self._index.save(path)

    def load(self, path: str):
        from cphnsw_tpu.api import scan_index

        header = _peek_header(path)
        magic = header.get("magic")
        if magic == scan_index.MAGIC:
            name = "scan"
        elif magic == MAGIC:
            name = "graph"
        else:
            raise ValueError("Not a CPHNSW-TPU index file.")
        if self._engine_req != "auto" and name != self._engine_req:
            raise ValueError(
                f"Index file engine={name!r} mismatches requested "
                f"engine={self._engine_req!r}"
            )
        if self.engine != name:
            self._index = self._make_engine(name)
        self._index.load(path)

    def _require_index(self):
        if self._index is None:
            raise RuntimeError("Index must be finalized before searching.")

    @property
    def size(self) -> int:
        return 0 if self._index is None else self._index.size

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def is_finalized(self) -> bool:
        return self._index is not None and self._index.is_finalized


def _peek_header(path) -> dict:
    """Read just the header JSON of a saved index npz."""
    with np.load(path) as z:
        if "header" not in z:
            raise ValueError("Not a CPHNSW-TPU index file.")
        return json.loads(bytes(z["header"].tobytes()).decode())
