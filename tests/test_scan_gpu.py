"""The scan+select kernel compiled for the card, against the XLA path.

Marked `gpu`: these skip on the CPU and run on a card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.  Their CPU twins
(the same kernel in interpret mode) are in test_scan.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex
from cphnsw_tpu.ops import hadamard, pack, quantize
from cphnsw_tpu.search import scan


def _clustered(rng, n, dim, n_clusters=64):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [128, 960, 1536])  # P = 128, 1024, 2048
def test_kernel_matches_xla_path_on_gpu(gpu, rng, dim):
    n, nq = 32768, 256
    base = _clustered(rng, n, dim)
    idx = ScanIndex(dim, bits=1).build(base).finalize()
    arrays = idx._arrays
    p = arrays.raw.shape[1]
    queries = base[rng.choice(n, nq, replace=False)] + 0.1 * (
        rng.standard_normal((nq, dim)).astype(np.float32)
    )
    qpad = hadamard.pad_to(jnp.asarray(queries), p)

    # 1. the int32 tile product is bit-exact against XLA's int8 GEMM
    q_u = quantize.encode_queries(qpad, idx._signs).q_u.astype(jnp.int8)
    codes = pack.unpack_codes_i8(arrays.planes[:4096], p)
    fs_k = np.asarray(scan.fused_fs(codes, q_u))
    fs_x = np.asarray(jax.lax.dot_general(
        q_u, codes, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ))
    np.testing.assert_array_equal(fs_k, fs_x)

    # 2. candidates agree; 3. reranked distances of agreeing ids match
    n_pad = arrays.raw.shape[0]
    chunk, n_eq, rem = scan.chunk_plan(n_pad, nq)
    aff_a, aff_b, n_dev = idx._dev_scalars
    kw = dict(kappa=1.0, k=10, top_c=min(idx._budget.top_c(10, n), chunk),
              chunk=chunk, n_eq=n_eq, rem=rem)
    ids_x, d_x = scan.scan_search(arrays, qpad, idx._signs, aff_a, aff_b,
                                  n_dev, fused=False, **kw)
    ids_f, d_f = scan.scan_search(arrays, qpad, idx._signs, aff_a, aff_b,
                                  n_dev, fused=True, **kw)
    ids_x, ids_f = np.asarray(ids_x), np.asarray(ids_f)
    overlap = (ids_x[:, :, None] == ids_f[:, None, :]).any(-1).mean()
    assert overlap >= 0.99, f"kernel/xla candidate overlap {overlap}"
    agree = ids_x == ids_f
    np.testing.assert_allclose(np.asarray(d_x)[agree],
                               np.asarray(d_f)[agree], rtol=1e-6)


@pytest.mark.gpu
def test_scan_index_uses_compiled_kernel_on_gpu(gpu, rng):
    """On the card ScanIndex takes the kernel (sketch-scan selection)
    and returns exact f32 distances of its ids."""
    n, dim = 100_000, 96
    base = _clustered(rng, n, dim)
    idx = ScanIndex(dim, bits=1).build(base).finalize()
    assert idx._use_fused()
    queries = base[rng.choice(n, 512, replace=False)] + 0.1 * (
        rng.standard_normal((512, dim)).astype(np.float32)
    )
    ids, dists = idx.search_batch(queries, k=10)
    d = (
        (queries ** 2).sum(1)[:, None] - 2.0 * queries @ base.T
        + (base ** 2).sum(1)[None, :]
    )
    gt = np.argsort(d, 1)[:, :10]
    recall = (ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert recall >= 0.98, recall
    exact = ((queries[:, None, :] - base[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, exact, rtol=1e-5, atol=1e-3)
