"""Dataset loaders: fvecs/ivecs + npy benchmark sets.

Mirrors /root/reference/cphnsw/datasets.py:8-52 (same on-disk formats and
dataset registry), plus a synthetic generator used when no benchmark data is
mounted (so `bench.py` and smoke evals always run).
"""

from __future__ import annotations

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

FVECS_DATASETS = {
    "sift1m": {
        "base": "sift_base.fvecs",
        "queries": "sift_query.fvecs",
        "groundtruth": "sift_groundtruth.ivecs",
    },
    "gist1m": {
        "base": "gist_base.fvecs",
        "queries": "gist_query.fvecs",
        "groundtruth": "gist_groundtruth.ivecs",
    },
}

NPY_DATASETS = {"openai1536", "msmarco10m", "deep10m"}

ALL_DATASETS = list(FVECS_DATASETS.keys()) + sorted(NPY_DATASETS)


def read_fvecs(path: Path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.float32)
    dim = raw[:1].view(np.int32)[0]
    return raw.reshape(-1, dim + 1)[:, 1:].copy()


def read_ivecs(path: Path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    k = int(raw[0])
    return raw.reshape(-1, k + 1)[:, 1:].copy()


def load_dataset(name: str, base_dir: Path) -> dict:
    base_path = Path(base_dir) / name
    if name in FVECS_DATASETS:
        files = FVECS_DATASETS[name]
        base = read_fvecs(base_path / files["base"])
        queries = read_fvecs(base_path / files["queries"])
        groundtruth = read_ivecs(base_path / files["groundtruth"])
    elif name in NPY_DATASETS:
        base = np.load(base_path / "base.npy").astype(np.float32)
        queries = np.load(base_path / "queries.npy").astype(np.float32)
        groundtruth = np.load(base_path / "groundtruth.npy").astype(np.int32)
    elif name.startswith("synthetic"):
        return make_synthetic(name)
    else:
        raise ValueError(f"Unknown dataset: {name}")
    return {
        "base": base,
        "queries": queries,
        "groundtruth": groundtruth,
        "dim": base.shape[1],
    }


@functools.partial(jax.jit, static_argnames=("dim", "n_clusters", "seed"))
def synthetic_rows(idx, dim: int, n_clusters: int, seed: int):
    """Rows `idx` of the clustered-gaussian store, generated on the
    device.  Every row draws from its own key (fold_in of its index), so
    any slice of the store — one shard's rows, the query sources — comes
    out identical to the same rows of the whole store."""
    kc, ka, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    centers = jax.random.normal(kc, (n_clusters, dim), jnp.float32) * 3.0
    assign = jax.vmap(
        lambda i: jax.random.randint(
            jax.random.fold_in(ka, i), (), 0, n_clusters
        )
    )(idx)
    noise = jax.vmap(
        lambda i: jax.random.normal(
            jax.random.fold_in(kn, i), (dim,), jnp.float32
        )
    )(idx)
    return centers[assign] + noise


def synthetic_queries(n, dim, n_queries, n_clusters, seed):
    """(n_queries, dim) host queries: distinct store rows plus 0.1-sigma
    gaussian jitter, drawn from the same seed as the store."""
    kq, kqn = jax.random.split(jax.random.PRNGKey(seed + 1))
    qi = jax.random.choice(kq, n, (n_queries,), replace=False)
    src = synthetic_rows(qi, dim, n_clusters, seed)
    return np.asarray(
        src + 0.1 * jax.random.normal(kqn, (n_queries, dim), jnp.float32)
    )


def _device_synthetic(n, dim, n_queries, n_clusters, seed):
    """Generate the clustered-gaussian store ON the accelerator (no
    store-sized host transfer; threefry is bitwise deterministic, so
    every process sees the same data).  Returns (base_dev (n, dim) f32
    on device, queries np (n_queries, dim))."""
    base = synthetic_rows(jnp.arange(n), dim, n_clusters, seed)
    return base, synthetic_queries(n, dim, n_queries, n_clusters, seed)


def _device_groundtruth(
    base,
    queries: np.ndarray,
    gt_k: int,
    metric: str = "l2",
    row_chunk: int = 1 << 19,
    q_block: int = 512,
) -> np.ndarray:
    """Exact ground truth via chunked device matmuls.

    The host O(nq*n*d) loop cannot scale past ~1M rows; on an
    accelerator the same computation is a few seconds of f32 matmuls
    (precision=HIGHEST — reduced-precision passes would corrupt the
    ground truth) with a carried exact top-k merge across fixed-size
    row chunks.
    """
    n, dim = base.shape
    n_pad = -(-n // row_chunk) * row_chunk
    base_d = jnp.asarray(base)  # no-op when already device-resident
    if n_pad != n:
        base_d = jnp.pad(base_d, ((0, n_pad - n), (0, 0)))
    # pad-row norms become +inf so they can never enter the top-k
    norm_d = jnp.where(
        jnp.arange(n_pad) < n,
        jnp.sum(base_d.astype(jnp.float32) ** 2, axis=1),
        np.float32(np.finfo(np.float32).max),
    )
    valid_d = jnp.arange(n_pad) < n

    # base/norms are ARGUMENTS, not closure captures: a captured array
    # would be embedded in the program as a constant
    @jax.jit
    def block_gt(qb, base_d, norm_d, valid_d):
        qn = jnp.sum(qb * qb, axis=1)
        carry_neg = jnp.full((qb.shape[0], gt_k), -jnp.inf)
        carry_ids = jnp.zeros((qb.shape[0], gt_k), jnp.int32)
        for c in range(n_pad // row_chunk):
            rows = jax.lax.slice_in_dim(
                base_d, c * row_chunk, (c + 1) * row_chunk, axis=0
            )
            rnorm = jax.lax.slice_in_dim(
                norm_d, c * row_chunk, (c + 1) * row_chunk, axis=0
            )
            dots = jax.lax.dot_general(
                qb, rows,
                dimension_numbers=(((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
            )
            if metric == "ip":
                vmask = jax.lax.slice_in_dim(
                    valid_d, c * row_chunk, (c + 1) * row_chunk, axis=0
                )
                d = jnp.where(vmask[None, :], -dots, jnp.inf)
            else:
                d = qn[:, None] + rnorm[None, :] - 2.0 * dots
            neg, idx = jax.lax.top_k(-d, gt_k)
            ids = idx.astype(jnp.int32) + c * row_chunk
            cat_neg = jnp.concatenate([carry_neg, neg], axis=1)
            cat_ids = jnp.concatenate([carry_ids, ids], axis=1)
            carry_neg, keep = jax.lax.top_k(cat_neg, gt_k)
            carry_ids = jnp.take_along_axis(cat_ids, keep, axis=1)
        return carry_ids

    gt = np.empty((len(queries), gt_k), np.int32)
    for s in range(0, len(queries), q_block):
        qb = queries[s : s + q_block]
        if len(qb) < q_block:  # pad to the jitted block shape
            qb = np.concatenate(
                [qb, np.zeros((q_block - len(qb), dim), np.float32)]
            )
        out = np.asarray(
            block_gt(jax.device_put(qb), base_d, norm_d, valid_d)
        )
        gt[s : s + q_block] = out[: len(queries) - s]
    return gt


def make_synthetic(
    name: str = "synthetic",
    n: int = 100_000,
    dim: int = 128,
    n_queries: int = 1000,
    gt_k: int = 100,
    n_clusters: int = 256,
    seed: int = 0,
    cache_dir: str | None = str(
        Path(tempfile.gettempdir()) / "cphnsw_synth_cache"
    ),
) -> dict:
    """Clustered gaussian data with exact ground truth.

    `name` may encode size, e.g. "synthetic-100k-128d".  Ground-truth
    computation is O(n_queries * n * dim) on the host, so results are
    cached on disk keyed by the full parameter tuple.
    """
    parts = name.split("-")
    metric = "l2"
    for p in parts[1:]:
        if p == "ip":
            metric = "ip"  # e.g. synthetic-100k-1536d-ip
        elif p.endswith("k"):
            n = int(float(p[:-1]) * 1000)
        elif p.endswith("m"):
            n = int(float(p[:-1]) * 1_000_000)
        elif p.endswith("d"):
            dim = int(p[:-1])
    # Large stores are generated ON the accelerator (threefry is
    # bitwise-deterministic, so the store regenerates identically in
    # seconds instead of crossing to the device) and the ground truth is
    # computed on-device; small stores use the host numpy recipe.
    use_device = (
        n * dim >= (64 << 20) and jax.default_backend() != "cpu"
    )

    if use_device:
        key = (f"{name}-{n}-{dim}-{n_queries}-{gt_k}-{n_clusters}-"
               f"{seed}-dev")
        cpath = Path(cache_dir) / f"{key}.npz" if cache_dir else None
        # the device store is handed out as a REGENERATING factory, not a
        # held array: a multi-GB base_dev need not stay alive alongside a
        # built index when regeneration from the PRNG costs seconds
        def base_dev_factory():
            b, _ = _device_synthetic(n, dim, n_queries, n_clusters, seed)
            return b

        if cpath is not None and cpath.exists():
            with np.load(cpath) as z:
                return {
                    "base": z["base"], "queries": z["queries"],
                    "groundtruth": z["groundtruth"], "dim": int(z["dim"]),
                    "metric": metric, "base_dev_factory": base_dev_factory,
                }
        base_dev, queries = _device_synthetic(
            n, dim, n_queries, n_clusters, seed
        )
        gt = _device_groundtruth(base_dev, queries, gt_k, metric=metric)
        base = np.asarray(base_dev)  # host copy (eval ADR + cache)
        del base_dev
        if cpath is not None:
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            np.savez(cpath, base=base, queries=queries, groundtruth=gt,
                     dim=dim)
        return {
            "base": base, "queries": queries, "groundtruth": gt,
            "dim": dim, "metric": metric,
            "base_dev_factory": base_dev_factory,
        }

    if cache_dir:
        key = f"{name}-{n}-{dim}-{n_queries}-{gt_k}-{n_clusters}-{seed}"
        cpath = Path(cache_dir) / f"{key}.npz"
        if cpath.exists():
            with np.load(cpath) as z:
                return {
                    "base": z["base"], "queries": z["queries"],
                    "groundtruth": z["groundtruth"], "dim": int(z["dim"]),
                    "metric": metric,
                }
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    qi = rng.choice(n, n_queries, replace=False)
    queries = base[qi] + 0.1 * rng.standard_normal((n_queries, dim)).astype(
        np.float32
    )
    gt = np.empty((n_queries, gt_k), dtype=np.int32)
    bs = 256
    for s in range(0, n_queries, bs):
        q = queries[s : s + bs]
        if metric == "ip":
            d = -(q @ base.T)
        else:
            d = (
                (q**2).sum(1)[:, None]
                - 2.0 * q @ base.T
                + (base**2).sum(1)[None, :]
            )
        gt[s : s + bs] = np.argpartition(d, gt_k, axis=1)[:, :gt_k][
            np.arange(len(q))[:, None],
            np.argsort(
                np.take_along_axis(
                    d, np.argpartition(d, gt_k, axis=1)[:, :gt_k], axis=1
                ),
                axis=1,
            ),
        ]
    if cache_dir:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        np.savez(cpath, base=base, queries=queries, groundtruth=gt, dim=dim)
    return {
        "base": base,
        "queries": queries,
        "groundtruth": gt,
        "dim": dim,
        "metric": metric,
    }
