"""RaBitQ / CAQ quantization: database codes, edge residuals, query encoding.

Batched re-expression of the reference encoder
(/root/reference/include/cphnsw/encoder/rabitq_encoder.hpp):

  * encode_vectors      <- RaBitQEncoder::encode_impl (1-bit, :225-263) and
                           NbitRaBitQEncoder::encode_impl (:326-352), batched
                           over all N vectors as one XLA program.
  * caq_quantize        <- caq_quantize coordinate descent (:371-467),
                           sequential in the coordinate axis (lax.fori_loop)
                           but parallel over the whole vector batch.
  * encode_residuals    <- compute_neighbor_aux / compute_neighbor_aux_nbit
                           (:138-181, :287-323), batched over all edges.
  * encode_queries      <- encode_query_raw + build_lut (:73-79, :98-136).
                           The 16-entry VPSHUFB LUT is unnecessary here —
                           the same decode algebra A*fs + B*wpc + C is kept
                           with fs computed as an integer matmul.

All semantics comments about ip_qo / ip_cp carrying an un-normalized
||c_bar|| factor that cancels in the estimator ratio (codes.hpp:52-76,
rabitq_encoder.hpp:355-370) apply unchanged here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cphnsw_tpu.ops import hadamard

# Numerical-stability tiers (reference core/constants.hpp:10-15).
EPS_TINY = 1e-20
EPS_SMALL = 1e-12
EPS_MEDIUM = 1e-10

# 4-bit query quantization levels (reference constants.hpp:61).
LUT_LEVELS = 15.0

CAQ_MAX_ITERS = 10
CAQ_EARLY_EXIT_TOL = 1e-4  # reference constants.hpp:58


def norm_epsilon(padded_dim: int) -> float:
    """Dimension-scaled zero-norm guard (reference constants.hpp:84-86)."""
    return 1e-8 / float(padded_dim)


def coordinate_epsilon(padded_dim: int) -> float:
    return 1e-10 / float(padded_dim)


class EncodedVectors(NamedTuple):
    """Batched equivalent of RaBitQCode / NbitRaBitQCode arrays (SoA)."""

    u: jax.Array       # (N, P) int32 code levels in [0, 2^bits - 1]
    nop: jax.Array     # (N,)  ||x - centroid||  (or ||n - p|| for residuals)
    ip_qo: jax.Array   # (N,)  <c_bar, rotated>/sqrt(P)


class EncodedResiduals(NamedTuple):
    u: jax.Array       # (E, P) int32
    nop: jax.Array     # (E,)
    ip_qo: jax.Array   # (E,)
    ip_cp: jax.Array   # (E,)  <c_bar, rotated_parent>/sqrt(P)


class QueryCode(NamedTuple):
    """Batched equivalent of RaBitQQuery (core/codes.hpp:78-93).

    q_u replaces the nibble LUT: fs = <code_u, q_u> is computed directly as
    an integer matmul, and A*fs + B*wpc + C reconstructs the same quantity the
    reference's VPSHUFB LUT scan accumulates.
    """

    q_u: jax.Array      # (Q, P) int32 quantized query levels in [0, 15]
    coeff_a: jax.Array  # (Q,) 2*delta/sqrt(P)
    coeff_b: jax.Array  # (Q,) 2*vmin/sqrt(P)
    coeff_c: jax.Array  # (Q,) -(P*vmin + delta*sum_u)/sqrt(P)
    q_rot: jax.Array    # (Q, P) rotated query (for exact-dot paths / rerank)


def compute_centroid(vectors: jax.Array) -> jax.Array:
    """Dataset mean (reference encoder/rabitq_encoder.hpp:42-54)."""
    return jnp.mean(vectors, axis=0)


def _c_bar(u: jax.Array, bits: int) -> jax.Array:
    k = float((1 << bits) - 1)
    return (2.0 * u.astype(jnp.float32) - k) / k


def _center_normalize_rotate(
    vectors: jax.Array, centroid: jax.Array, signs: jax.Array
):
    """Shared front half of encode_impl: center, norm, normalize, rotate."""
    p = signs.shape[-1]
    centered = vectors - centroid
    nop = jnp.linalg.norm(centered, axis=-1)
    eps = norm_epsilon(p)
    safe = nop >= eps
    inv = jnp.where(safe, 1.0 / jnp.maximum(nop, eps), 0.0)
    normalized = centered * inv[..., None]
    rotated = hadamard.rotate(hadamard.pad_to(normalized, p), signs)
    return rotated, nop, safe


@functools.partial(jax.jit, static_argnames=("bits",))
def caq_quantize(
    rotated: jax.Array, bits: int, rotated_parent: jax.Array | None = None
):
    """CAQ coordinate-descent quantization, batched over vectors.

    rotated: (V, P) rotated unit vectors.  Returns (u (V,P) int32,
    ip_qo (V,), ip_cp (V,) or None).

    For bits == 1 the CAQ optimum is exactly the sign code (c = sign(x)
    maximizes |<c, x>| over {-1,1}^P), so no iterations are needed — this
    reproduces the reference 1-bit encoder (rabitq_encoder.hpp:253-259).

    For bits in {2, 3}: exhaustive K+1 candidate sweep per coordinate; for
    bits >= 4: SAQ-style +/-1 moves (reference :413-439).  The sweep is a
    lax.fori_loop over the P coordinates — sequential in P (the algorithm's
    data dependence) but fully parallel across the vector batch, so the VPU
    stays busy; see SURVEY.md section 7 "CAQ coordinate descent".
    """
    v, p = rotated.shape
    k_int = (1 << bits) - 1
    k = float(k_int)
    inv_sqrt_p = 1.0 / jnp.sqrt(float(p))

    if bits == 1:
        u = (rotated >= 0.0).astype(jnp.int32)
        cbar = _c_bar(u, 1)
        ip_qo = jnp.sum(cbar * rotated, axis=-1) * inv_sqrt_p
        ip_cp = None
        if rotated_parent is not None:
            ip_cp = jnp.sum(cbar * rotated_parent, axis=-1) * inv_sqrt_p
        return u, ip_qo, ip_cp

    # LVQ uniform init (reference :377-399)
    vmin = jnp.min(rotated, axis=-1, keepdims=True)
    vmax = jnp.max(rotated, axis=-1, keepdims=True)
    delta = jnp.maximum((vmax - vmin) / k, coordinate_epsilon(p))
    u0 = jnp.clip(
        jnp.round((rotated - vmin) / delta).astype(jnp.int32), 0, k_int
    )
    c0 = _c_bar(u0, bits)
    dot0 = jnp.sum(c0 * rotated, axis=-1)
    norm0 = jnp.sum(c0 * c0, axis=-1)

    # Coordinate-contiguous layouts for the sweep.
    rot_t = rotated.T  # (P, V)
    codes_t0 = u0.T    # (P, V)

    if bits >= 4:
        deltas = jnp.array([-1, 1], dtype=jnp.int32)

        def candidates_for(u_old):
            return u_old[None, :] + deltas[:, None]  # (2, V)
    else:
        all_u = jnp.arange(k_int + 1, dtype=jnp.int32)

        def candidates_for(u_old):
            return jnp.broadcast_to(all_u[:, None], (k_int + 1, v))

    def coord_step(carry, xs):
        """One coordinate update for the whole batch (scanned over P)."""
        dot, norm, nchanged = carry
        r_i, u_old = xs                                 # (V,), (V,)
        c_old = (2.0 * u_old.astype(jnp.float32) - k) / k
        dot_wo = dot - c_old * r_i
        norm_wo = norm - c_old * c_old

        cand_u = candidates_for(u_old)                  # (C, V)
        valid = (cand_u >= 0) & (cand_u <= k_int)
        c_new = (2.0 * cand_u.astype(jnp.float32) - k) / k
        new_dot = dot_wo[None] + c_new * r_i[None]
        new_norm = norm_wo[None] + c_new * c_new
        score = new_dot * new_dot / jnp.maximum(new_norm, EPS_TINY)
        score = jnp.where(valid, score, -jnp.inf)

        score_old = dot * dot / jnp.maximum(norm, EPS_TINY)
        best_idx = jnp.argmax(score, axis=0)
        best_score = jnp.take_along_axis(score, best_idx[None], axis=0)[0]
        improved = best_score > score_old  # strict, like the reference sweep
        u_best = jnp.take_along_axis(cand_u, best_idx[None], axis=0)[0]
        u_next = jnp.where(improved, u_best, u_old)
        c_next = (2.0 * u_next.astype(jnp.float32) - k) / k
        dot = jnp.where(improved, dot_wo + c_next * r_i, dot)
        norm = jnp.where(improved, norm_wo + c_next * c_next, norm)
        nchanged = nchanged + improved.astype(jnp.int32)
        return (dot, norm, nchanged), u_next

    def sweep(state):
        codes_t, dot, norm, prev_cos, it, _ = state
        (dot, norm, nchanged), codes_t = jax.lax.scan(
            coord_step,
            (dot, norm, jnp.zeros(v, jnp.int32)),
            (rot_t, codes_t),
        )
        cos_sq = dot * dot / jnp.maximum(norm, EPS_TINY)
        any_changed = jnp.any(nchanged > 0)
        improving = jnp.any(
            (cos_sq - prev_cos) >= CAQ_EARLY_EXIT_TOL
        ) | (it == 0)
        keep_going = any_changed & improving
        return codes_t, dot, norm, cos_sq, it + 1, keep_going

    def cond(state):
        _, _, _, _, it, keep_going = state
        return (it < CAQ_MAX_ITERS) & keep_going

    init = (codes_t0, dot0, norm0, jnp.zeros(v), jnp.int32(0), jnp.bool_(True))
    codes_t, dot, _, _, _, _ = jax.lax.while_loop(cond, sweep, init)

    u = codes_t.T
    ip_qo = dot * inv_sqrt_p
    ip_cp = None
    if rotated_parent is not None:
        cbar = _c_bar(u, bits)
        ip_cp = jnp.sum(cbar * rotated_parent, axis=-1) * inv_sqrt_p
    return u, ip_qo, ip_cp


@functools.partial(jax.jit, static_argnames=("bits",))
def encode_vectors(
    vectors: jax.Array, centroid: jax.Array, signs: jax.Array, bits: int
) -> EncodedVectors:
    """Encode database vectors against the dataset centroid.

    Batched equivalent of encode_batch + encode_impl
    (rabitq_encoder.hpp:56-71, :225-263, :326-352).
    """
    rotated, nop, safe = _center_normalize_rotate(vectors, centroid, signs)
    u, ip_qo, _ = caq_quantize(rotated, bits)
    u = jnp.where(safe[:, None], u, 0)
    ip_qo = jnp.where(safe, ip_qo, 0.0)
    return EncodedVectors(u=u, nop=nop, ip_qo=ip_qo)


@functools.partial(jax.jit, static_argnames=("bits",))
def encode_residuals(
    parent_vecs: jax.Array,
    neighbor_vecs: jax.Array,
    rotated_parents: jax.Array,
    signs: jax.Array,
    bits: int,
) -> EncodedResiduals:
    """Encode edge residuals (n - p)/||n - p|| relative to parent vertices.

    Batched equivalent of compute_neighbor_aux (1-bit, :138-181) and
    compute_neighbor_aux_nbit (:287-323).  rotated_parents must be the
    orthonormally rotated RAW parent vectors (rotate_raw).
    """
    p = signs.shape[-1]
    diff = neighbor_vecs - parent_vecs
    nop = jnp.linalg.norm(diff, axis=-1)
    eps = norm_epsilon(p)
    safe = nop >= eps
    inv = jnp.where(safe, 1.0 / jnp.maximum(nop, eps), 0.0)
    rotated = hadamard.rotate(hadamard.pad_to(diff * inv[:, None], p), signs)
    u, ip_qo, ip_cp = caq_quantize(rotated, bits, rotated_parents)
    u = jnp.where(safe[:, None], u, 0)
    ip_qo = jnp.where(safe, ip_qo, 0.0)
    ip_cp = jnp.where(safe, ip_cp, 0.0)
    return EncodedResiduals(u=u, nop=nop, ip_qo=ip_qo, ip_cp=ip_cp)


@jax.jit
def encode_queries(queries: jax.Array, signs: jax.Array) -> QueryCode:
    """Rotate + 4-bit uniform-quantize a batch of raw queries.

    Batched equivalent of encode_query_raw + build_lut
    (rabitq_encoder.hpp:73-79, :98-136).  Queries are NOT centered — the
    estimator subtracts ip_cp = <c_bar, rot(parent)> downstream, which by
    linearity of the rotation yields <c_bar, rot(q - p)>.
    """
    p = signs.shape[-1]
    inv_sqrt_p = 1.0 / jnp.sqrt(float(p))
    q_rot = hadamard.rotate(hadamard.pad_to(queries, p), signs)

    vmin = jnp.min(q_rot, axis=-1)
    vmax = jnp.max(q_rot, axis=-1)
    delta = jnp.maximum((vmax - vmin) / LUT_LEVELS, EPS_TINY)
    q_u = jnp.clip(
        jnp.round((q_rot - vmin[:, None]) / delta[:, None]).astype(jnp.int32),
        0,
        int(LUT_LEVELS),
    )
    sum_u = q_u.sum(axis=-1).astype(jnp.float32)
    coeff_a = 2.0 * delta * inv_sqrt_p
    coeff_b = 2.0 * vmin * inv_sqrt_p
    coeff_c = -(float(p) * vmin + delta * sum_u) * inv_sqrt_p
    return QueryCode(
        q_u=q_u, coeff_a=coeff_a, coeff_b=coeff_b, coeff_c=coeff_c, q_rot=q_rot
    )
