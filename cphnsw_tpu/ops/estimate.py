"""Distance estimation: matmul fastscan + distance/lower-bound conversion.

Accelerator re-expression of the reference FastScan kernels
(/root/reference/include/cphnsw/distance/fastscan_kernel.hpp).

The AVX2 VPSHUFB 16-entry LUT scan (:17-87) exists on CPU because there is no
small-matmul unit; on an accelerator the accumulated quantity
fs = sum_d u_d * qbar_d is just an integer contraction, so it runs as a
(batched) matmul over
the quantized query levels.  The decode algebra ip = A*fs + B*wpc + C and the
distance/lower-bound formulas (:89-194, :220-346) are kept verbatim so the
EVT-CRC calibration math carries over unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cphnsw_tpu.ops.quantize import EPS_MEDIUM, EPS_SMALL

FLOAT_MAX = jnp.finfo(jnp.float32).max


class CalibParams(NamedTuple):
    """Query-time calibration constants stamped into the query struct
    (reference RaBitQQuery fields, core/codes.hpp:89-92, stamped at
    api/hnsw_index.hpp:183-186)."""

    affine_a: jax.Array | float = 1.0
    affine_b: jax.Array | float = 0.0
    ip_qo_floor: jax.Array | float = 0.0
    dot_slack: jax.Array | float = 0.0


def fastscan_sums(codes_u: jax.Array, q_u: jax.Array) -> jax.Array:
    """fs[..., c] = sum_d codes_u[..., c, d] * q_u[..., d]  (int32).

    codes_u: (..., C, P) integer code levels; q_u: (..., P) quantized query.
    The matmul replacement for compute_inner_products
    (fastscan_kernel.hpp:17-87) — one contraction instead of nibble shuffles.
    """
    return jax.lax.dot_general(
        codes_u.astype(jnp.int32),
        q_u.astype(jnp.int32)[..., None],
        dimension_numbers=(
            ((codes_u.ndim - 1,), (q_u.ndim - 1,)),
            (tuple(range(codes_u.ndim - 2)), tuple(range(q_u.ndim - 1))),
        ),
        preferred_element_type=jnp.int32,
    )[..., 0]


def ip_from_fastscan(
    fs: jax.Array,
    wpc: jax.Array,
    coeff_a: jax.Array,
    coeff_b: jax.Array,
    coeff_c: jax.Array,
    k_scale: float,
) -> jax.Array:
    """ip_approx = (A/k)*fs + (B/k)*wpc + C.

    k_scale = 1 for 1-bit (fastscan_kernel.hpp:102-104 and :177-178),
    2^bits - 1 for N-bit (:235-239), 3 (or 1) for the MSB partial decode
    (:383-388).  coeff_* broadcast against fs (per-query scalars).
    """
    inv_k = 1.0 / k_scale
    return (
        coeff_a * inv_k * fs.astype(jnp.float32)
        + coeff_b * inv_k * wpc.astype(jnp.float32)
        + coeff_c
    )


def estimate_ip(ip_approx, ip_qo, ip_cp, calib: CalibParams):
    """Calibrated inner-product estimate (fastscan_kernel.hpp:148-154).

    Returns (ip_est, mask_good).  Where ip_qo is degenerate the raw ratio is
    zeroed before the affine map (so ip_est == affine_b there), matching both
    the AVX and scalar-tail reference paths.
    """
    ip_qo_p = jnp.maximum(ip_qo, calib.ip_qo_floor)
    mask_good = ip_qo_p > EPS_MEDIUM
    ratio = jnp.where(
        mask_good, (ip_approx - ip_cp) / jnp.maximum(ip_qo_p, EPS_MEDIUM), 0.0
    )
    return calib.affine_a * ratio + calib.affine_b, mask_good


def distances_with_bounds(
    ip_approx: jax.Array,
    ip_approx_bound: jax.Array,
    nop: jax.Array,
    ip_qo: jax.Array,
    ip_cp: jax.Array,
    dist_qp_sq: jax.Array,
    calib: CalibParams,
):
    """Estimated distance + certified-ish lower bound, elementwise.

    Mirrors convert_to_distances_with_bounds (1-bit: ip_approx_bound is the
    same full-precision ip_approx, fastscan_kernel.hpp:89-194) and
    convert_nbit_to_distances_with_bounds (N-bit: ip_approx_bound is the MSB
    partial decode, :220-346):

      est   = max(nop^2 + d_qp^2 - 2*nop*ip_est, 0)
      cos+  = clamp((ip_est_bound + dot_slack)/sqrt(d_qp^2), -1, 1)
      lower = max(nop^2 + d_qp^2 - 2*nop*sqrt(d_qp^2)*cos+, 0)

    The d_qp^2 ~ 0 special case (query sitting on the parent, :112-119)
    becomes an elementwise select so mixed query batches stay branch-free.
    """
    sqrt_dqp = jnp.sqrt(jnp.maximum(dist_qp_sq, 0.0))
    ip_est, mask_good = estimate_ip(ip_approx, ip_qo, ip_cp, calib)
    est = jnp.maximum(nop * nop + dist_qp_sq - 2.0 * nop * ip_est, 0.0)

    ip_est_b, _ = estimate_ip(ip_approx_bound, ip_qo, ip_cp, calib)
    cos_upper = jnp.clip(
        (ip_est_b + calib.dot_slack) / jnp.maximum(sqrt_dqp, EPS_MEDIUM),
        -1.0,
        1.0,
    )
    lower = jnp.maximum(
        nop * nop + dist_qp_sq - 2.0 * nop * sqrt_dqp * cos_upper, 0.0
    )
    lower = jnp.where(mask_good, lower, 0.0)

    degenerate = dist_qp_sq < EPS_SMALL
    est = jnp.where(degenerate, nop * nop + dist_qp_sq, est)
    lower = jnp.where(degenerate, 0.0, lower)
    return est, lower


def exact_l2_sq(
    queries: jax.Array,
    query_norm_sq: jax.Array,
    vectors: jax.Array,
    vec_norm_sq: jax.Array,
) -> jax.Array:
    """max(|q|^2 + |v|^2 - 2<q,v>, 0) for batched q (..., P) x v (..., C, P).

    The gathered rerank path (reference exact_l2 lambda,
    search/rabitq_search.hpp:90-93, via dot_product_simd).  <q,v> is an
    f32 elementwise product summed over P, not a dot: XLA's reduction
    fixes the summation order by shape, where a dot's autotuned GEMM
    (tiles, split-K) can sum in another order in another program — so a
    (query, row) pair gets the same f32 distance from every program
    that reranks it.
    """
    dots = jnp.sum(
        vectors.astype(jnp.float32)
        * queries.astype(jnp.float32)[..., None, :],
        axis=-1,
    )
    return jnp.maximum(
        query_norm_sq[..., None] + vec_norm_sq - 2.0 * dots, 0.0
    )
