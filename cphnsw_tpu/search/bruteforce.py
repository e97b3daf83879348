"""Graph-free RaBitQ brute-force scan: the minimum end-to-end slice.

Estimate the distance from each query to ALL database vectors with the
calibrated RaBitQ estimator (one int matmul over the whole code matrix),
take the top-C candidates by estimate, then exact-L2 rerank the candidates
with a gathered matmul (SURVEY.md section 7, build-order step 3).

Here every node's "parent" is the dataset centroid, so the per-node aux data
is exactly the global RaBitQCode (nop, ip_qo) plus ip_cp computed against
rotate_raw(centroid) — the same estimator algebra as the graph search uses
per edge (reference distance/fastscan_kernel.hpp:89-194).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.ops import estimate, hadamard, quantize
from cphnsw_tpu.calibration import huber


class BruteForceStore(NamedTuple):
    """Device-resident state for the graph-free scan."""

    raw: jax.Array          # (N, P) zero-padded raw vectors
    norm_sq: jax.Array      # (N,)
    codes_u: jax.Array      # (N, P) int8 code levels
    nop: jax.Array          # (N,)
    ip_qo: jax.Array        # (N,)
    ip_cp: jax.Array        # (N,)  <c_bar, rot(centroid)>/sqrt(P)
    wpc: jax.Array          # (N,) int32 weighted popcounts
    centroid: jax.Array     # (P,)
    signs: jax.Array        # (3, P)


def build_store(
    vectors: np.ndarray, bits: int, seed: int = hadamard.DEFAULT_ROTATION_SEED
) -> BruteForceStore:
    dim = vectors.shape[1]
    p = hadamard.next_pow2(dim)
    signs = hadamard.rotation_signs(seed, p)
    raw = hadamard.pad_to(jnp.asarray(vectors, dtype=jnp.float32), p)
    centroid = quantize.compute_centroid(raw)
    enc = quantize.encode_vectors(raw, centroid, signs, bits)
    rot_centroid = hadamard.rotate(centroid, signs)
    k = float((1 << bits) - 1)
    cbar = (2.0 * enc.u.astype(jnp.float32) - k) / k
    ip_cp = jnp.matmul(
        cbar, rot_centroid, precision=jax.lax.Precision.HIGHEST
    ) / jnp.sqrt(float(p))
    return BruteForceStore(
        raw=raw,
        norm_sq=jnp.sum(raw * raw, axis=-1),
        codes_u=enc.u.astype(jnp.int8),
        nop=enc.nop,
        ip_qo=enc.ip_qo,
        ip_cp=ip_cp,
        wpc=enc.u.sum(axis=-1).astype(jnp.int32),
        centroid=centroid,
        signs=signs,
    )


@functools.partial(jax.jit, static_argnames=("bits", "k", "top_c"))
def search(
    store: BruteForceStore,
    queries: jax.Array,
    calib: estimate.CalibParams,
    bits: int,
    k: int,
    top_c: int,
):
    """Scan + rerank.  queries: (Q, dim).  Returns (ids (Q,k), dists (Q,k))."""
    p = store.signs.shape[-1]
    qpad = hadamard.pad_to(queries.astype(jnp.float32), p)
    qc = quantize.encode_queries(qpad, store.signs)

    # Full-database fastscan: one (Q, P) x (P, N) int matmul.
    fs = jax.lax.dot_general(
        qc.q_u.astype(jnp.int32),
        store.codes_u.astype(jnp.int32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (Q, N)
    k_scale = float((1 << bits) - 1)
    ip_approx = estimate.ip_from_fastscan(
        fs,
        store.wpc[None, :],
        qc.coeff_a[:, None],
        qc.coeff_b[:, None],
        qc.coeff_c[:, None],
        k_scale,
    )
    dist_qc_sq = jnp.sum((qpad - store.centroid) ** 2, axis=-1)  # (Q,)
    est, _ = estimate.distances_with_bounds(
        ip_approx,
        ip_approx,
        store.nop[None, :],
        store.ip_qo[None, :],
        store.ip_cp[None, :],
        dist_qc_sq[:, None],
        calib,
    )

    # Top-C candidates by estimate, exact-L2 rerank (gathered matmul).
    _, cand_ids = jax.lax.top_k(-est, top_c)
    cand_vecs = store.raw[cand_ids]          # (Q, C, P)
    cand_norms = store.norm_sq[cand_ids]     # (Q, C)
    qnorm = jnp.sum(qpad * qpad, axis=-1)
    exact = estimate.exact_l2_sq(qpad, qnorm, cand_vecs, cand_norms)
    neg_d, idx = jax.lax.top_k(-exact, k)
    return jnp.take_along_axis(cand_ids, idx, axis=1), -neg_d


def calibrate_affine(
    store: BruteForceStore, bits: int, num_samples: int = 2000, seed: int = 99999
) -> estimate.CalibParams:
    """Affine estimator correction for the brute-force slice.

    A light version of calibrate_estimator (hnsw_index.hpp:718-1017): sample
    database vectors as queries, compare the raw estimator ratio against the
    true <q - c, (x - c)/||x - c||>, Huber-fit the affine map, and derive
    ip_qo_floor from the MAD lower fence.  (EVT/gamma/slack machinery only
    matters for beam-search termination and is fitted by the full pipeline.)
    """
    n = store.raw.shape[0]
    rng = np.random.default_rng(seed)
    n_s = min(num_samples, n)
    q_ids = rng.choice(n, size=n_s, replace=False)
    x_ids = rng.integers(0, n, size=n_s)

    qvecs = store.raw[jnp.asarray(q_ids)]
    p = store.signs.shape[-1]
    qc = quantize.encode_queries(qvecs, store.signs)
    codes = store.codes_u[jnp.asarray(x_ids)].astype(jnp.int32)
    fs = jnp.einsum("sp,sp->s", qc.q_u, codes)
    k_scale = float((1 << bits) - 1)
    ip_approx = estimate.ip_from_fastscan(
        fs, store.wpc[jnp.asarray(x_ids)], qc.coeff_a, qc.coeff_b, qc.coeff_c,
        k_scale,
    )
    ip_qo = np.asarray(store.ip_qo)[x_ids]
    ip_cp = np.asarray(store.ip_cp)[x_ids]
    nop = np.asarray(store.nop)[x_ids]

    centroid = np.asarray(store.centroid)
    xvecs = np.asarray(store.raw)[x_ids]
    qv = np.asarray(qvecs)
    true_ip = ((qv - centroid) * (xvecs - centroid)).sum(-1) / np.maximum(
        nop, 1e-12
    )

    ip_qo_floor = huber.mad_lower_fence(np.abs(ip_qo))
    denom = np.maximum(np.abs(ip_qo), ip_qo_floor)
    raw_est = (np.asarray(ip_approx) - ip_cp) / denom
    good = nop > 1e-6
    a, b, _ = huber.fit_affine_huber(raw_est[good], true_ip[good])
    return estimate.CalibParams(
        affine_a=a, affine_b=b, ip_qo_floor=ip_qo_floor, dot_slack=0.0
    )


class BruteForceIndex:
    """Convenience facade for the graph-free slice (used by tests/bench)."""

    def __init__(self, dim: int, bits: int = 1):
        self.dim = dim
        self.bits = bits
        self.store: BruteForceStore | None = None
        self.calib: estimate.CalibParams | None = None

    def build(self, vectors: np.ndarray):
        self.store = build_store(vectors, self.bits)
        self.calib = calibrate_affine(self.store, self.bits)
        return self

    def search_batch(self, queries: np.ndarray, k: int = 10, top_c: int | None = None):
        if top_c is None:
            top_c = max(4 * k, 100)
        top_c = min(top_c, self.store.raw.shape[0])
        k = min(k, top_c)
        ids, dists = search(
            self.store, jnp.asarray(queries), self.calib, self.bits, k, top_c
        )
        return np.asarray(ids), np.asarray(dists)
