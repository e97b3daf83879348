"""Batched fast Walsh-Hadamard transform and random Hadamard rotation.

Batched re-expression of the reference's in-register AVX2 FHT butterfly
(/root/reference/include/cphnsw/encoder/transform/fht.hpp:23-57) and the
3-layer random sign rotation (encoder/rotation.hpp:15-67).

Design notes:
  * The transform is expressed as log2(P) reshape/stack stages over the last
    axis, batched over arbitrary leading axes.  XLA fuses the stages into a
    handful of vector ops; no scalar loops, no data-dependent shapes.
  * Like the reference, each FWHT pass is UNNORMALIZED (scales the L2 norm by
    sqrt(P)); the combined normalization 1/(P*sqrt(P)) for the three passes is
    applied once at the end (reference encoder/rabitq_encoder.hpp:30-39).
  * Sign layers are Rademacher vectors drawn from a seeded JAX PRNG — our own
    reproducible stream (the on-disk format validates the seed, like
    api/hnsw_index.hpp:363-365; bit-compat with mt19937 is not a goal).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NUM_ROTATION_LAYERS = 3
DEFAULT_ROTATION_SEED = 42


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference core/util.hpp:7-11)."""
    p = 1
    while p < n:
        p *= 2
    return p


def fwht(x: jax.Array) -> jax.Array:
    """Unnormalized fast Walsh-Hadamard transform along the last axis.

    Last-axis length must be a power of two.  Batched over leading axes.
    """
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"FWHT length must be a power of two, got {d}")
    batch_shape = x.shape[:-1]
    h = 1
    while h < d:
        x = x.reshape(*batch_shape, d // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = jnp.stack([a + b, a - b], axis=-2).reshape(*batch_shape, d)
        h *= 2
    return x


def rotation_signs(seed: int, padded_dim: int) -> jax.Array:
    """(NUM_LAYERS, padded_dim) Rademacher sign layers from a seed."""
    key = jax.random.PRNGKey(seed)
    return jax.random.rademacher(
        key, (NUM_ROTATION_LAYERS, padded_dim), dtype=jnp.float32
    )


@functools.partial(jax.jit, static_argnames=())
def rotate(x: jax.Array, signs: jax.Array) -> jax.Array:
    """Apply the 3-layer random Hadamard rotation with combined normalization.

    x: (..., P) already padded to the power-of-two dim P == signs.shape[1].
    Returns the rotated vectors scaled by P**-1.5 so the rotation is
    orthonormal overall (norm-preserving), matching the reference's
    norm_factor_ (encoder/rabitq_encoder.hpp:37-39).
    """
    p = signs.shape[-1]
    for layer in range(NUM_ROTATION_LAYERS):
        x = fwht(x * signs[layer])
    return x * (float(p) ** -1.5)


def pad_to(x: jax.Array, padded_dim: int) -> jax.Array:
    """Zero-pad the last axis to padded_dim (reference rotation.hpp:45-49)."""
    d = x.shape[-1]
    if d == padded_dim:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, padded_dim - d)]
    return jnp.pad(x, pad)


def rotate_raw(x: jax.Array, signs: jax.Array) -> jax.Array:
    """Pad + rotate raw (unnormalized) vectors.

    Mirrors RaBitQEncoderBase::rotate_raw_vector
    (encoder/rabitq_encoder.hpp:81-86): no centering, no normalization of the
    input — just the orthonormal rotation of the zero-padded vector.
    """
    return rotate(pad_to(x, signs.shape[-1]), signs)
