"""Tests for the production full-DB scan engine + ScanIndex facade."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex
from cphnsw_tpu.ops import estimate, hadamard, pack, quantize
from cphnsw_tpu.search import scan


def make_clustered(rng, n=4000, dim=48, n_clusters=32):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


def brute_gt(base, queries, k):
    d = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :k]


def _build(rng, n=4000, dim=48, bits=1):
    base = make_clustered(rng, n=n, dim=dim)
    idx = ScanIndex(dim, bits=bits).build(base).finalize()
    return base, idx


def test_folded_score_matches_reference_algebra(rng):
    """The folded rank-5 score equals the unfolded calibrated estimate
    up to the dropped per-query constant d_qc^2 (and without the >=0
    clamp, which only reorders nodes the estimate puts past the query)."""
    base = make_clustered(rng, n=1024, dim=32)
    bits = 2
    dim = base.shape[1]
    p = hadamard.next_pow2(dim)
    signs = hadamard.rotation_signs(42, p)
    raw = hadamard.pad_to(jnp.asarray(base), p)
    centroid = quantize.compute_centroid(raw)
    enc = quantize.encode_vectors(raw, centroid, signs, bits)
    kappa = float((1 << bits) - 1)
    cbar = (2.0 * enc.u.astype(jnp.float32) - kappa) / kappa
    ip_cp = cbar @ hadamard.rotate(centroid, signs) / jnp.sqrt(float(p))
    wpc = enc.u.sum(axis=-1).astype(jnp.int32)
    planes = pack.pack_planes(enc.u, bits)

    a, b, floor = 1.07, -0.03, float(np.quantile(np.asarray(enc.ip_qo), 0.02))
    n = raw.shape[0]
    node_aux = scan.fold_node_constants(
        enc.nop, enc.ip_qo, ip_cp, wpc, jnp.asarray(floor, jnp.float32),
        jnp.asarray(n),
    )

    queries = jnp.asarray(
        make_clustered(rng, n=16, dim=dim) + 0.05
    )
    qpad = hadamard.pad_to(queries, p)
    qc, w_fs, y_aux = scan._query_side(qpad, signs, a, b, kappa)
    folded = scan._chunk_scores(
        planes, node_aux, qc.q_u.astype(jnp.int8), w_fs, y_aux, p
    )

    # unfolded path (ops/estimate.py, the same algebra the beam search uses)
    fs = jax.lax.dot_general(
        qc.q_u, enc.u,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    ip_approx = estimate.ip_from_fastscan(
        fs, wpc[None, :], qc.coeff_a[:, None], qc.coeff_b[:, None],
        qc.coeff_c[:, None], kappa,
    )
    calib = estimate.CalibParams(affine_a=a, affine_b=b, ip_qo_floor=floor)
    ip_est, _ = estimate.estimate_ip(
        ip_approx, enc.ip_qo[None, :], ip_cp[None, :], calib
    )
    dqc = jnp.sum((qpad - centroid) ** 2, axis=-1)
    unfolded = (
        enc.nop[None, :] ** 2 + dqc[:, None]
        - 2.0 * enc.nop[None, :] * ip_est
    )
    np.testing.assert_allclose(
        np.asarray(folded + dqc[:, None]), np.asarray(unfolded),
        rtol=1e-3, atol=1e-2,
    )


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_scan_index_recall(rng, bits):
    base, idx = _build(rng, bits=bits)
    queries = base[rng.choice(len(base), 50, replace=False)] + (
        0.1 * rng.standard_normal((50, base.shape[1])).astype(np.float32)
    )
    gt = brute_gt(base, queries, 10)
    ids, dists = idx.search_batch(queries, k=10)
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall >= 0.9, f"bits={bits}: recall@10={recall}"

    # reranked distances are exact distances from the f32 query (up to
    # f32 rounding of |q|^2 + |x|^2 - 2<q,x>) and sorted
    q64, x64 = queries.astype(np.float64), base[ids].astype(np.float64)
    d_true = ((q64[:, None, :] - x64) ** 2).sum(-1)
    scale = (q64 ** 2).sum(-1)[:, None] + (x64 ** 2).sum(-1)
    assert (np.abs(dists - d_true) / scale).max() <= 1e-5
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_code_memory_matches_reference(rng, bits):
    """At-rest code memory must equal the reference's bits*P/8 bytes per
    vector (core/codes.hpp:96-135) — the 'equal code memory' north star."""
    base, idx = _build(rng, n=1000, dim=64, bits=bits)
    n_pad = idx._arrays.raw.shape[0]
    p = idx._arrays.raw.shape[1]
    assert idx._arrays.planes.dtype == jnp.uint32
    code_bytes = idx._arrays.planes.size * 4
    assert code_bytes == n_pad * bits * p // 8
    # packed codes scored identically to the unpacked ints they encode
    u = pack.unpack_planes(idx._arrays.planes, p)
    assert int(jnp.max(u)) <= (1 << bits) - 1
    u8 = pack.unpack_codes_i8(idx._arrays.planes, p)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u8))


def test_chunked_equals_unchunked(rng):
    base, idx = _build(rng, n=3000, dim=32, bits=2)
    queries = make_clustered(rng, n=64, dim=32)
    n_pad = idx._arrays.raw.shape[0]

    kw = dict(
        signs=idx._signs,
        affine_a=jnp.asarray(idx._affine_a, jnp.float32),
        affine_b=jnp.asarray(idx._affine_b, jnp.float32),
        n=jnp.asarray(idx._n),
        kappa=3.0, k=10, top_c=128, exact_select=True,
    )
    ids1, d1 = scan.scan_search(
        idx._arrays, jnp.asarray(queries), chunk=n_pad, n_eq=1, rem=0, **kw
    )
    # equal chunks + remainder chunk (unrolled static slices)
    c = n_pad // 4 // 256 * 256
    n_eq = 3
    rem = n_pad - n_eq * c
    ids2, d2 = scan.scan_search(
        idx._arrays, jnp.asarray(queries), chunk=c, n_eq=n_eq, rem=rem, **kw
    )
    np.testing.assert_array_equal(np.asarray(ids1), np.asarray(ids2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)

    # rolled lax.scan path (n_eq > MAX_UNROLL) must agree too; use fresh
    # static args so the patched unroll limit is seen at trace time
    old = scan.MAX_UNROLL
    scan.MAX_UNROLL = 2
    try:
        n_eq2 = (n_pad // 256) - 1
        ids3, d3 = scan.scan_search(
            idx._arrays, jnp.asarray(queries), chunk=256, n_eq=n_eq2,
            rem=n_pad - 256 * n_eq2, **kw
        )
    finally:
        scan.MAX_UNROLL = old
    np.testing.assert_array_equal(np.asarray(ids1), np.asarray(ids3))


def test_candidate_budget_interpolation():
    b = scan.CandidateBudget(
        anchors=np.asarray([1, 10, 100], np.int64),
        ranks=np.asarray([8, 40, 300], np.int64),
    )
    n = 100_000
    assert b.top_c(1, n) >= 8
    assert b.top_c(10, n) >= 40
    assert b.top_c(100, n) >= 300
    assert b.top_c(10, n) <= b.top_c(50, n) <= b.top_c(100, n)
    # extrapolation beyond the last anchor keeps growing
    assert b.top_c(500, n) > b.top_c(100, n)
    # never below min(4k, n) and never above n
    assert b.top_c(1000, 2000) <= 2000


def test_save_load_round_trip(rng, tmp_path):
    base, idx = _build(rng, n=2000, dim=24, bits=2)
    queries = make_clustered(rng, n=32, dim=24)
    ids0, d0 = idx.search_batch(queries, k=10)

    f = tmp_path / "scan.npz"
    idx.save(f)
    idx2 = ScanIndex(24, bits=2).load(f)
    assert idx2.size == idx.size and idx2.is_finalized
    ids1, d1 = idx2.search_batch(queries, k=10)
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5)

    with pytest.raises(ValueError):
        ScanIndex(24, bits=1).load(f)
    with pytest.raises(ValueError):
        ScanIndex(23, bits=2).load(f)
    with pytest.raises(ValueError):
        ScanIndex(24, bits=2, metric="ip").load(f)


def test_ip_metric_round_trip(rng, tmp_path):
    base = make_clustered(rng, n=2000, dim=24)
    queries = make_clustered(rng, n=32, dim=24)
    idx = ScanIndex(24, bits=4, metric="ip").build(base).finalize()
    ids, scores = idx.search_batch(queries, k=10)

    true_ip = queries @ base.T
    gt = np.argsort(-true_ip, axis=1)[:, :10]
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall >= 0.85, f"ip recall@10={recall}"
    # scores are the actual inner products, descending
    got = np.take_along_axis(true_ip, ids, axis=1)
    np.testing.assert_allclose(scores, got, rtol=1e-3, atol=1e-2)
    assert np.all(np.diff(scores, axis=1) <= 1e-4)

    f = tmp_path / "scan_ip.npz"
    idx.save(f)
    idx2 = ScanIndex(24, bits=4, metric="ip").load(f)
    ids1, s1 = idx2.search_batch(queries, k=10)
    np.testing.assert_array_equal(ids, ids1)
    np.testing.assert_allclose(scores, s1, rtol=1e-5)


def test_k_exceeds_n(rng):
    base = make_clustered(rng, n=300, dim=16)
    idx = ScanIndex(16, bits=1).build(base).finalize()
    ids, dists = idx.search_batch(base[:8], k=512)
    assert ids.shape == (8, 512)
    assert (ids[:, 300:] == -1).all()
    assert np.isfinite(dists[:, :300]).all()
    # self-match must surface at rank 0 with distance ~0
    assert (ids[:, 0] == np.arange(8)).all()


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_fused_kernel_matches_xla_path(rng, bits):
    """The Pallas scan+select kernel (interpret mode on CPU) must return
    the same candidates/results as the chunked XLA path (scores differ
    by ~1 ulp of FMA rounding, so compare the reranked output sets)."""
    base, idx = _build(rng, n=3000, dim=32, bits=bits)
    queries = base[rng.choice(3000, 64, replace=False)] + 0.05
    qpad = jnp.asarray(queries)
    n_pad = idx._arrays.raw.shape[0]
    chunk, n_eq, rem = scan.chunk_plan(n_pad, 64)
    aff_a, aff_b, n_dev = idx._dev_scalars
    kw = dict(
        kappa=float((1 << bits) - 1), k=10,
        top_c=min(idx._budget.top_c(10, 3000), chunk),
        chunk=chunk, n_eq=n_eq, rem=rem,
    )
    ids_x, d_x = scan.scan_search(
        idx._arrays, qpad, idx._signs, aff_a, aff_b, n_dev, **kw
    )
    ids_f, d_f = scan.scan_search(
        idx._arrays, qpad, idx._signs, aff_a, aff_b, n_dev,
        fused=True, interpret=True, **kw
    )
    ids_x, ids_f = np.asarray(ids_x), np.asarray(ids_f)
    overlap = (ids_x[:, :, None] == ids_f[:, None, :]).any(-1).mean()
    assert overlap > 0.99, f"fused/xla candidate overlap {overlap}"
    # distances of the agreeing entries are identical (exact rerank)
    agree = ids_x == ids_f
    np.testing.assert_allclose(
        np.asarray(d_x)[agree], np.asarray(d_f)[agree], rtol=1e-6
    )


def test_build_from_device_array(rng):
    """build() accepts a device-resident jax.Array (the no-upload path
    used for on-device generated stores) and produces the same index as
    the host path."""
    base = make_clustered(rng, n=2000, dim=24)
    queries = base[rng.choice(2000, 32, replace=False)] + 0.05
    h = ScanIndex(24, bits=1).build(base).finalize()
    d = ScanIndex(24, bits=1).build(jnp.asarray(base)).finalize()
    ids_h, d_h = h.search_batch(queries, k=10)
    ids_d, d_d = d.search_batch(queries, k=10)
    np.testing.assert_array_equal(ids_h, ids_d)
    np.testing.assert_allclose(d_h, d_d, rtol=1e-6, atol=1e-5)

    # ip metric through the device path (augmented column on device)
    hi = ScanIndex(24, bits=1, metric="ip").build(base).finalize()
    di = ScanIndex(24, bits=1, metric="ip").build(
        jnp.asarray(base)
    ).finalize()
    s_h = hi.search_batch(queries, k=5)
    s_d = di.search_batch(queries, k=5)
    np.testing.assert_array_equal(s_h[0], s_d[0])


def test_sketch_scan_mode(rng):
    """The int8 sketch-scan branch (huge candidate budgets stream the
    sketch store through the kernel instead of gathering top_c
    rows) must return near-exact results: the int8 sketch's distance
    error is far below survivor-cutoff gaps and the final rerank is
    exact f32."""
    n, dim = 20000, 24
    x = rng.standard_normal((n, dim)).astype(np.float32)
    idx = ScanIndex(dim, bits=1).build(x).finalize()
    arrays = idx._arrays
    sketch = scan.make_rerank_sketch(arrays.raw, arrays.norm_sq,
                                     force_int8=True)
    assert sketch.scale is not None
    queries = x[rng.choice(n, 64, replace=False)] + 0.01
    qpad = jnp.asarray(queries)
    n_pad = arrays.raw.shape[0]
    chunk, n_eq, rem = scan.chunk_plan(n_pad, 64)
    aff_a, aff_b, n_dev = idx._dev_scalars
    top_c = 8192
    ids_s, d_s = scan.scan_search(
        arrays, qpad, idx._signs, aff_a, aff_b, n_dev, kappa=1.0,
        k=10, top_c=top_c, chunk=chunk, n_eq=n_eq, rem=rem,
        fused=True, interpret=True, sketch=sketch,
    )
    # exact ground truth
    d = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    ids_s = np.asarray(ids_s)
    recall = (ids_s[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall > 0.99, f"sketch-scan recall {recall}"
    # distances are exact f32 for returned ids
    want = d[np.arange(64)[:, None], np.maximum(ids_s, 0)]
    valid = ids_s >= 0
    np.testing.assert_allclose(
        np.asarray(d_s)[valid], want[valid], rtol=1e-4, atol=1e-4
    )


def test_derived_sub_batch_scales_down():
    """Selection transients bound the sub-batch: small stores keep the
    cap, the 10M 1-bit budget (bins ~52k) must drop it so the key
    planes and decode scratch stay near 1 GB."""
    assert scan.derived_sub_batch(102400, 384) == 2048
    sub = scan.derived_sub_batch(10_000_128, 26080)
    assert sub <= 1024
    bins = scan.fused_bin_plan(10_000_128, 26080)[0]
    assert sub * bins * 24 <= (1 << 30) or sub == 256


def test_rerank_sketch_int8_accuracy(rng):
    """The int8 sketch's reconstruction error must be below 1% of the
    per-dimension range — enough that stage-1 survivor selection with a
    4k buffer cannot demote a true top-k candidate."""
    x = (rng.standard_normal((4096, 32)) * 3.0).astype(np.float32)
    xj = jnp.asarray(x)
    sk = scan.make_rerank_sketch(xj, jnp.sum(xj * xj, -1),
                                 force_int8=True)
    xhat = np.asarray(sk.store).astype(np.float32) * np.asarray(sk.scale)
    err = np.abs(xhat - x).max(axis=0)
    rng_d = np.abs(x).max(axis=0)
    assert (err <= rng_d / 127.0 + 1e-6).all()
    # sketch norms are the norms OF THE SKETCH points
    np.testing.assert_allclose(
        np.asarray(sk.norm_sq), (xhat ** 2).sum(-1), rtol=1e-5
    )


def test_candidate_budget_monotone():
    b = scan.CandidateBudget(
        anchors=np.asarray([1, 10, 100], np.int64),
        ranks=np.asarray([50, 400, 3000], np.int64),
    )
    n = 1_000_000
    prev = 0
    for k in (1, 5, 10, 50, 100, 500):
        c = b.top_c(k, n)
        assert c >= prev, (k, c, prev)
        assert c >= min(4 * k, n)
        prev = c


@pytest.mark.parametrize("p", [32, 512])  # one contraction slice / a loop
def test_kernel_tile_product_matches_xla(rng, p):
    """The kernel's int8 tile product (interpret mode) equals XLA's int8
    GEMM bit for bit; P=512 runs the FUSED_BK-sliced contraction loop."""
    codes = jnp.asarray(rng.integers(-127, 128, (256, p)), jnp.int8)
    q_u = jnp.asarray(rng.integers(0, 16, (128, p)), jnp.int8)
    fs_k = scan.fused_fs(codes, q_u, interpret=True)
    fs_x = jax.lax.dot_general(
        q_u, codes, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    np.testing.assert_array_equal(np.asarray(fs_k), np.asarray(fs_x))


def test_fused_bin_plan_tiles_the_store():
    for n_pad, top_c in [(2816, 40), (102400, 384), (1_000_192, 3040),
                         (10_000_128, 26528)]:
        bins, groups, rows = scan.fused_bin_plan(n_pad, top_c)
        assert bins % scan.FUSED_BN == 0 and rows == bins * groups
        assert rows >= n_pad and groups <= 1 << scan.GROUP_BITS
        assert bins >= min(scan.FUSED_BIN_FACTOR * top_c, n_pad)
    for p in (16, 128, 256, 1024, 2048):
        assert scan.FUSED_BN % scan.fused_block_bins(p) == 0


def test_gpu_backend_runs_the_compiled_kernel(rng, monkeypatch):
    """The kernel is chosen on the GPU backend only, and ScanIndex never
    asks for interpret mode: on the card it compiles or fails loudly."""
    assert not scan.use_kernel()  # the CPU backend: XLA chunked path
    monkeypatch.setattr(scan.jax, "default_backend", lambda: "gpu")
    assert scan.use_kernel()
    monkeypatch.undo()
    base, idx = _build(rng, n=1000, dim=16, bits=1)
    seen = []
    real = scan.scan_search

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **{**kw, "interpret": True})

    idx._fused = True  # what a GPU backend selects
    monkeypatch.setattr(scan, "scan_search", spy)
    ids, _ = idx.search_batch(base[:8], k=5)
    assert seen and all(kw["fused"] and "interpret" not in kw for kw in seen)
    assert (ids[:, 0] == np.arange(8)).all()


def test_search_plan_modes(rng):
    base, idx = _build(rng, n=6000, dim=16, bits=1)
    plan = idx.search_plan(10)
    assert plan["mode"] == "estimate-select" and not plan["kernel"]
    assert plan["top_c"] == idx._budget.top_c(10, 6000)
    idx._budget = scan.CandidateBudget(
        anchors=np.asarray([1, 10, 100], np.int64),
        ranks=np.asarray([8, scan.TWO_STAGE_MIN_C, 3000], np.int64),
    )
    assert idx.search_plan(10)["mode"] == "two-stage-gather"
    idx._fused = True
    plan = idx.search_plan(10)
    assert plan["mode"] == "sketch-scan" and plan["kernel"]
    # the kernel path selects survivors, so its sub-batch follows them
    assert plan["sub_batch"] == scan.derived_sub_batch(
        idx._arrays.raw.shape[0], scan._rerank_survivors(10, plan["top_c"])
    )
