"""Bit-plane packing of N-bit RaBitQ codes.

Device-array equivalent of the reference's word-packed code storage
(/root/reference/include/cphnsw/core/codes.hpp:96-135): codes u in [0, 2^B-1]
are stored as B bit-planes, MSB first (plane 0 holds the most significant
bit), each plane packed 32 coordinates per uint32 word.

Packed layout is the at-rest / serialized representation (8-32x smaller than
unpacked int8, so scans are memory-bandwidth-friendly); scans unpack tiles
on the fly right before the int8 contraction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WORD_BITS = 32


def num_words(padded_dim: int) -> int:
    return (padded_dim + WORD_BITS - 1) // WORD_BITS


def pack_planes(u: jax.Array, bits: int) -> jax.Array:
    """Pack integer codes (..., P) -> uint32 planes (..., bits, P//32).

    Plane b (MSB first) holds bit (bits-1-b) of each code value; coordinate
    j*32+i maps to bit i of word j, matching NbitCodeStorage::set_value
    semantics (core/codes.hpp:107-116) in spirit.
    """
    p = u.shape[-1]
    w = num_words(p)
    u = u.astype(jnp.uint32)
    if p != w * WORD_BITS:
        u = jnp.pad(u, [(0, 0)] * (u.ndim - 1) + [(0, w * WORD_BITS - p)])
    # (..., bits, P): bit of each plane
    shifts = jnp.arange(bits - 1, -1, -1, dtype=jnp.uint32)  # MSB first
    plane_bits = (u[..., None, :] >> shifts[:, None]) & jnp.uint32(1)
    # pack 32 consecutive coordinates into one word
    plane_bits = plane_bits.reshape(*plane_bits.shape[:-1], w, WORD_BITS)
    weights = (jnp.uint32(1) << jnp.arange(WORD_BITS, dtype=jnp.uint32))
    return (plane_bits * weights).sum(axis=-1).astype(jnp.uint32)


def unpack_planes(planes: jax.Array, padded_dim: int) -> jax.Array:
    """Unpack uint32 planes (..., bits, W) -> integer codes (..., P) int32.

    Inverse of pack_planes: u = sum_b 2^(bits-1-b) * plane_b.
    """
    bits = planes.shape[-2]
    bit_idx = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    # (..., bits, W, 32) -> (..., bits, W*32)
    expanded = (planes[..., None] >> bit_idx) & jnp.uint32(1)
    expanded = expanded.reshape(*planes.shape[:-1], -1)[..., :padded_dim]
    weights = (jnp.uint32(1) << jnp.arange(bits - 1, -1, -1, dtype=jnp.uint32))
    return (expanded * weights[:, None]).sum(axis=-2).astype(jnp.int32)


# Rows per unpack step for store-sized inputs: the shift/mask chain's
# u32 intermediates do NOT always fuse (XLA can materialize the
# broadcast and the post-reshape copy at full size — 2 x 4.78 GB at 10M
# rows), so whole-store unpacks roll through a lax.scan whose
# per-step temps are bounded at ~256 MB while only the int8 OUTPUT
# exists at full size.
UNPACK_CHUNK = 1 << 18


def _unpack_codes_i8_flat(planes: jax.Array, padded_dim: int) -> jax.Array:
    bits = planes.shape[-2]
    bit_idx = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    x = ((planes[..., None] >> bit_idx) & jnp.uint32(1)).astype(jnp.int8)
    x = x.reshape(*planes.shape[:-1], -1)[..., :padded_dim]  # (..., bits, P)
    weights = (
        jnp.int8(1) << jnp.arange(bits - 1, -1, -1, dtype=jnp.int8)
    )
    return jnp.sum(x * weights[:, None], axis=-2, dtype=jnp.int8)


def unpack_codes_i8(planes: jax.Array, padded_dim: int) -> jax.Array:
    """Unpack uint32 planes (..., bits, W) -> combined codes (..., P) int8.

    Same recombination as unpack_planes (u = sum_b 2^(bits-1-b) * plane_b)
    but int8 end-to-end; code values are <= 15, so int8 is exact.  Inputs
    with a large leading row axis unpack in UNPACK_CHUNK-row steps (see
    note above).
    """
    if planes.ndim != 3 or planes.shape[0] <= UNPACK_CHUNK:
        return _unpack_codes_i8_flat(planes, padded_dim)
    n, b, w = planes.shape
    n_eq = n // UNPACK_CHUNK
    rem = n - n_eq * UNPACK_CHUNK

    def body(_, pl_c):
        return None, _unpack_codes_i8_flat(pl_c, padded_dim)

    _, parts = jax.lax.scan(
        body, None,
        planes[: n_eq * UNPACK_CHUNK].reshape(n_eq, UNPACK_CHUNK, b, w),
    )
    out = parts.reshape(n_eq * UNPACK_CHUNK, padded_dim)
    if rem:
        out = jnp.concatenate(
            [out, _unpack_codes_i8_flat(planes[n_eq * UNPACK_CHUNK:],
                                        padded_dim)]
        )
    return out


def unpack_msb(planes: jax.Array, padded_dim: int, bits: int) -> jax.Array:
    """Unpack only the MSB portion used for the two-stage lower bound.

    For bits < 2: plane 0 alone (values 0/1, K_partial = 1).
    For bits >= 2: planes 0-1 combined as 2*p0 + p1 (values 0..3,
    K_partial = 3), matching compute_msb_only_inner_products
    (distance/fastscan_kernel.hpp:349-368).
    """
    n_planes = 1 if bits < 2 else 2
    return unpack_planes(planes[..., :n_planes, :], padded_dim)


def weighted_popcount(u: jax.Array) -> jax.Array:
    """sum_d u_d over the last axis (== plane-popcount weighted 2^(B-1-b)).

    Matches NbitCodeStorage::weighted_popcount (core/codes.hpp:125-134).
    """
    return u.astype(jnp.int32).sum(axis=-1)
