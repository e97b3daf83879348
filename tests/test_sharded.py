import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cphnsw_tpu.calibration import calibrate as calib_mod
from cphnsw_tpu.graph.build import NeighborStore
from cphnsw_tpu.ops import hadamard
from cphnsw_tpu.parallel import sharded
from cphnsw_tpu.search import beam


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_search_matches_quality(rng):
    n, dim = 1600, 32
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, 16, n)] + rng.standard_normal((n, dim)).astype(
        np.float32
    )
    signs = hadamard.rotation_signs(42, 32)

    n_data, n_model = 2, 4
    mesh = sharded.make_mesh(n_data, n_model)
    store, new_to_old = sharded.build_sharded_store(
        x, bits=1, r=16, n_shards=n_model, signs=signs
    )
    store = sharded.shard_store(store, mesh)

    # calibrate once on shard 0's subgraph (cheap smoke-level calibration)
    profile = calib_mod.IndexProfile.derive(n // n_model, 32, 16, 1)
    nb0 = NeighborStore.pack(
        store.nbr_ids[0], store.nbr_planes[0], store.nbr_aux[0]
    )
    snap = calib_mod.calibrate(
        store.raw[0], store.norm_sq[0], nb0, signs, 1, profile
    )
    params = calib_mod.to_search_params(snap)

    queries = x[rng.choice(n, 32, replace=False)]
    d = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]

    ids, dists = sharded.sharded_search(
        store, jnp.asarray(queries), params, signs, mesh,
        bits=1, k=10, beam_cap=64, max_steps=300,
    )
    # sharded_search returns ids in the caller's original vector order
    mapped = np.asarray(ids)
    recall = (mapped[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall > 0.9, f"sharded recall@10={recall}"

    # distances exact
    valid = mapped >= 0
    want = d[np.arange(len(queries))[:, None], np.maximum(mapped, 0)]
    np.testing.assert_allclose(
        np.asarray(dists)[valid], want[valid], rtol=1e-3, atol=1e-3
    )


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices")
def test_single_vs_multi_shard_equivalence(rng):
    """A 1-model-shard mesh must reproduce the plain single-device search
    exactly (SURVEY section 4: single-chip vs sharded equality)."""
    n, dim = 600, 16
    x = rng.standard_normal((n, dim)).astype(np.float32)
    signs = hadamard.rotation_signs(42, 16)

    mesh = sharded.make_mesh(2, 1)
    store, new_to_old = sharded.build_sharded_store(
        x, bits=1, r=8, n_shards=1, signs=signs
    )
    store_sh = sharded.shard_store(store, mesh)

    params = beam.SearchParams.default()._replace(
        slack_levels=jnp.full(4, 2.0, jnp.float32),
        gamma=jnp.float32(2.0), gamma_max=jnp.float32(3.0),
    )
    queries = x[rng.choice(n, 16, replace=False)]

    ids_sh, d_sh = sharded.sharded_search(
        store_sh, jnp.asarray(queries), params, signs, mesh,
        bits=1, k=5, beam_cap=32, max_steps=64,
    )
    nb = NeighborStore.pack(
        store.nbr_ids[0], store.nbr_planes[0], store.nbr_aux[0]
    )
    ids_1, d_1 = beam.search_batch(
        store.raw[0], store.norm_sq[0], nb, store.entry_candidates[0],
        signs, jnp.asarray(queries), params, bits=1, k=5,
        beam_cap=32, max_steps=64,
    )
    # sharded path returns original ids; map the single-device BFS ids
    ids_1 = np.asarray(ids_1)
    ids_1_orig = np.where(
        ids_1 >= 0, new_to_old[np.maximum(ids_1, 0)], -1
    )
    np.testing.assert_array_equal(np.asarray(ids_sh), ids_1_orig)
    np.testing.assert_allclose(
        np.asarray(d_sh), np.asarray(d_1), rtol=1e-6
    )


def test_search_determinism(rng):
    """Functional purity: identical inputs give identical outputs."""
    n, dim = 500, 16
    x = rng.standard_normal((n, dim)).astype(np.float32)
    signs = hadamard.rotation_signs(42, 16)
    store, _ = sharded.build_sharded_store(
        x, bits=1, r=8, n_shards=1, signs=signs
    )
    nb = NeighborStore.pack(
        store.nbr_ids[0], store.nbr_planes[0], store.nbr_aux[0]
    )
    params = beam.SearchParams.default()._replace(
        slack_levels=jnp.full(4, 2.0, jnp.float32),
        gamma=jnp.float32(2.0), gamma_max=jnp.float32(3.0),
    )
    q = jnp.asarray(x[:8])
    out1 = beam.search_batch(
        store.raw[0], store.norm_sq[0], nb, store.entry_candidates[0],
        signs, q, params, bits=1, k=5, beam_cap=32, max_steps=64,
    )
    out2 = beam.search_batch(
        store.raw[0], store.norm_sq[0], nb, store.entry_candidates[0],
        signs, q, params, bits=1, k=5, beam_cap=32, max_steps=64,
    )
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))
    np.testing.assert_array_equal(np.asarray(out1[1]), np.asarray(out2[1]))


@pytest.fixture(scope="module")
def sharded_facade():
    """One built ShardedIndex shared by the facade tests (each build runs
    per-shard NNDescent + pooled calibration — the suite's heaviest
    fixture).  n=1507 is deliberately not divisible by the 4 model shards
    so the pad-row path is live in every test."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rng = np.random.default_rng(1234)
    n, dim = 1507, 24
    centers = rng.standard_normal((12, dim)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, 12, n)] + rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    mesh = sharded.make_mesh(2, 4)
    index = sharded.ShardedIndex(dim=dim, bits=1, r=16).build(x, mesh)
    return index, x, mesh


def test_sharded_index_facade(sharded_facade, rng):
    index, x, _ = sharded_facade
    n = len(x)
    queries = x[rng.choice(n, 32, replace=False)]
    d = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    ids, dists = index.search_batch(queries, k=10)
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall > 0.88, f"sharded facade recall@10={recall}"
    # derived step budget is live (no hand cap)
    assert index._step_budget and 16 <= index._step_budget[10] <= 512
    # arbitrary (non-data-axis-multiple) query counts work
    ids_odd, _ = index.search_batch(queries[:7], k=10)
    np.testing.assert_array_equal(ids_odd, ids[:7])


def test_sharded_pad_rows_masked(sharded_facade, rng):
    """n not divisible by n_shards: shard-padding duplicates must never
    appear in results (no fabricated ids, no duplicate ids per row)."""
    index, x, _ = sharded_facade
    n = len(x)
    # query near the final vector so its pad duplicates are top candidates
    queries = np.concatenate(
        [x[-1:] + 0.01, x[rng.choice(n, 15, replace=False)]]
    ).astype(np.float32)
    ids, _ = index.search_batch(queries, k=10)
    assert (ids < n).all()
    for row in ids:
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v), row


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_scan_equals_single_chip(rng):
    """The sharded scan (per-chip scan + all-gather top-k merge) must
    reproduce the single-chip ScanIndex result: per-shard top-k lists are
    exact within their shard, so the merge is lossless."""
    from cphnsw_tpu.api.scan_index import ScanIndex

    n, dim = 2000, 24
    centers = rng.standard_normal((12, dim)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, 12, n)] + rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    single = ScanIndex(dim, bits=1).build(x).finalize()
    queries = x[rng.choice(n, 32, replace=False)] + 0.01
    ids_1, d_1 = single.search_batch(queries, k=10)

    mesh = sharded.make_mesh(2, 4)
    idx = sharded.ShardedScanIndex(dim, bits=1)
    idx._inner = single  # reuse the finalized single-chip build
    idx._attach(mesh)
    ids_s, d_s = idx.search_batch(queries, k=10)
    np.testing.assert_array_equal(ids_s, ids_1)
    np.testing.assert_allclose(d_s, d_1, rtol=1e-5)

    # arbitrary (non-data-axis-multiple) query counts work
    ids_odd, _ = idx.search_batch(queries[:7], k=10)
    np.testing.assert_array_equal(ids_odd, ids_1[:7])

    # pad rows (store_pad(2000) > 2000, all in the last shard) never leak
    assert (ids_s < n).all()

    # k > n pads like the reference bindings
    ids_big, d_big = idx.search_batch(queries[:4], k=2005)
    assert ids_big.shape == (4, 2005)
    assert (ids_big[:, n:] == -1).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_scan_shard_native_build(rng):
    """Shard-native build: every store array
    is built through the mesh — no device ever holds more than its own
    1/S row slice — and quality matches the single-chip pipeline."""
    from cphnsw_tpu.api.scan_index import ScanIndex

    n, dim = 3000, 24
    centers = rng.standard_normal((12, dim)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, 12, n)] + rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    mesh = sharded.make_mesh(2, 4)
    idx = sharded.ShardedScanIndex(dim, bits=1).build(x, mesh)

    # simulated per-shard budget: the full store would not fit one
    # device, each 1/4 slice does — assert no device over-holds
    for f in ("planes", "raw", "node_aux", "norm_sq"):
        arr = getattr(idx._store, f)
        per_shard_budget = arr.nbytes / 4 + 1024
        for sh in arr.addressable_shards:
            assert sh.data.nbytes <= per_shard_budget, (f, sh.data.nbytes)

    queries = x[rng.choice(n, 32, replace=False)] + 0.01
    d = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    ids, dists = idx.search_batch(queries, k=10)
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall > 0.95, f"shard-native recall@10={recall}"
    assert (ids >= 0).all() and (ids < n).all()

    # the sharded pipeline derives the same calibration/budget *shape*
    # as a single-chip build of the same data (values differ only via
    # the per-shard sample draws)
    single = ScanIndex(dim, bits=1).build(x).finalize()
    ids1, _ = single.search_batch(queries, k=10)
    agree = (ids == ids1).mean()
    assert agree > 0.9, f"sharded vs single-chip id agreement {agree}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_scan_provider_build(rng):
    """Streaming build: a block provider (never materializing the full
    dataset) must reproduce the array-input build exactly — the
    Deep100M-shaped path where each shard's rows are generated or read
    on demand."""
    n, dim = 1500, 16
    x = rng.standard_normal((n, dim)).astype(np.float32)
    mesh = sharded.make_mesh(2, 4)

    calls = []

    def provider(s, start, rows):
        calls.append((s, start, rows))
        return x[start:start + rows]

    provider.n_rows = n
    idx_p = sharded.ShardedScanIndex(dim, bits=1).build(provider, mesh)
    idx_a = sharded.ShardedScanIndex(dim, bits=1).build(x, mesh)
    # provider is called per shard with contiguous non-overlapping rows
    rows_seen = sorted((st, st + r) for _, st, r in calls if r)
    assert rows_seen[0][0] == 0 and rows_seen[-1][1] >= n
    queries = x[rng.choice(n, 16, replace=False)]
    ids_p, d_p = idx_p.search_batch(queries, k=5)
    ids_a, d_a = idx_a.search_batch(queries, k=5)
    np.testing.assert_array_equal(ids_p, ids_a)
    np.testing.assert_allclose(d_p, d_a, rtol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_scan_save_load(rng, tmp_path):
    from cphnsw_tpu.api.scan_index import ScanIndex

    n, dim = 1200, 16
    x = rng.standard_normal((n, dim)).astype(np.float32)
    mesh = sharded.make_mesh(2, 4)
    idx = sharded.ShardedScanIndex(dim, bits=2).build(x, mesh)
    queries = x[rng.choice(n, 16, replace=False)]
    ids_a, d_a = idx.search_batch(queries, k=5)

    path = tmp_path / "sharded_scan.npz"
    idx.save(path)
    # the saved file is a plain ScanIndex snapshot: single-chip loadable.
    # Per-shard top-c selection is a SUPERSET of the global top-c (any
    # node in the global estimate top-c is also in its own shard's), so
    # the sharded result can only be equal or better — never worse.
    single = ScanIndex(dim, bits=2).load(path)
    ids_1, d_1 = single.search_batch(queries, k=5)
    assert (d_a <= d_1 + 1e-5).all()
    assert (ids_a == ids_1).mean() > 0.9

    loaded = sharded.ShardedScanIndex(dim, bits=2).load(path, mesh)
    ids_b, d_b = loaded.search_batch(queries, k=5)
    np.testing.assert_array_equal(ids_a, ids_b)
    # atol: load recomputes norm_sq in a different (fused) program than
    # build, so near-zero self-distances carry ~1-ulp accumulation noise
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6, atol=1e-4)


def test_sharded_index_save_load(sharded_facade, rng, tmp_path):
    index, x, mesh = sharded_facade
    dim = x.shape[1]
    path = tmp_path / "sharded.npz"
    index.save(path)

    loaded = sharded.ShardedIndex(dim=dim, bits=1, r=16).load(path, mesh)
    assert loaded._step_budget == index._step_budget
    queries = x[rng.choice(len(x), 16, replace=False)]
    ids_a, d_a = index.search_batch(queries, k=5)
    ids_b, d_b = loaded.search_batch(queries, k=5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_scan_skewed_partition(rng):
    """Adversarial partition: the dataset sorted so
    contiguous shards hold whole clusters — the worst case for pooled
    per-shard calibration/budget — must still clear the recall bar."""
    n, dim = 3000, 24
    centers = rng.standard_normal((8, dim)).astype(np.float32) * 4.0
    labels = rng.integers(0, 8, n)
    x = centers[labels] + rng.standard_normal((n, dim)).astype(np.float32)
    order = np.argsort(labels, kind="stable")
    x_sorted = np.ascontiguousarray(x[order])
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    mesh = sharded.make_mesh(2, 4)
    idx = sharded.ShardedScanIndex(dim, bits=1).build(x_sorted, mesh)
    queries = x[rng.choice(n, 32, replace=False)] + 0.01
    d = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = inv[np.argsort(d, 1)[:, :10]]
    ids, _ = idx.search_batch(queries, k=10)
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall > 0.95, f"skewed-partition recall@10={recall}"
