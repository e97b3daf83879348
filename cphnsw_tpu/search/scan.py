"""Full-database scan: the main search path.

The reference reaches sub-linear work per query with a pointer-chasing
graph traversal (search/rabitq_search.hpp:60-277) because a CPU core is
latency-optimized.  An accelerator is the opposite: one (Q, P) x (P, N)
int8 contraction estimates the distance from every query to EVERY
database code at matrix-unit rates, so at million scale the design is a
calibrated full scan + approximate top-C selection + exact rerank, not a
traversal.  This module is that path; the graph/beam stack
(search/beam.py) remains available as the reference-parity engine.

Algebra (exact same estimator as the reference, folded into one int8
matrix product):
the calibrated distance estimate (distance/fastscan_kernel.hpp:89-194)

    est = nop^2 + d_qc^2 - 2*nop*(a*(ip_approx - ip_cp)/max(ip_qo,floor) + b)
    ip_approx = (A/kappa)*fs + (B/kappa)*wpc + C,   fs = <codes_u, q_u>

is, per query, an affine function of fs: dropping the per-query constant
d_qc^2 (every node shares the dataset-centroid parent) the ranking score

    score = nop^2 - 2*b*nop - 2*a*g*(ip_approx - ip_cp),
    g     = nop / max(ip_qo, floor)   (0 where ip_qo is degenerate)

splits into one int8 matmul (fs) plus a rank-5 node-constant term,
with NO (Q, N) elementwise decode chain.  Selection is a fused
binned-min packed-key reduce (see GROUP_BITS below); candidates get the
same exact-L2 rerank as the reference (rabitq_search.hpp:132-133).

On the GPU one Pallas kernel (Triton route) computes the score tiles and
the per-bin selection keys without writing the score matrix; elsewhere
large N runs as XLA chunks of fixed size, so the (Q, N) score matrix
never materializes in device memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.ops import estimate, hadamard, pack, quantize
from cphnsw_tpu.ops.quantize import EPS_MEDIUM

FLOAT_MAX = jnp.finfo(jnp.float32).max
# Pad-row sentinel added to scores via the node-constant channel: large
# enough to rank last, small enough that (-score) stays finite.
PAD_SCORE = 1e30
# Candidate selection is a binned-minimum reduction (the same partial-
# reduction idea as lax.approx_max_k, hand-fused so the bin reduce is a
# PURE jnp.min that XLA fuses straight into the score epilogue instead
# of a custom-call barrier): scores are mapped to order-preserving u32
# keys, the bin-local group index is packed into the low GROUP_BITS of
# each key, and one min over the group axis yields both the bin minimum
# and (decoded from the low bits) its position — no variadic min+argmin
# reduce, no per-chunk approx_max_k.  The smallest
# top_c bin keys are then picked with ONE exact top_k over the reduced
# (Q, total_bins) key array and decoded back to row ids.
#
# Capture analysis: each bin keeps its TWO smallest keys (the group
# index packed in the low bits makes keys unique within a bin, so the
# exact second minimum is one masked re-reduce).  A candidate at
# estimate rank r is lost only if >= 2 better-scoring rows land in its
# bin: p_miss ~ (r/bins)^2 / 2.  With total bins = BIN_FACTOR * top_c
# even the budget's deepest needed rank (r ~ top_c) survives with
# ~1 - 1/(2*BIN_FACTOR^2) ~= 99.2%, and the head of the list (the true
# top-k, r << top_c) with ~1 - (r/bins)^2/2 >= 99.99%.  Masking
# the low GROUP_BITS of the score key only affects tie-breaks among
# scores equal to ~7 significand bits — selection is approximate and
# the rerank is exact, so this is free.
# 10 group bits: the score keeps the top 22 bits (4M distinct ranks —
# far below the f32 noise floor of the estimate), and groups of up to
# 1024 rows per bin keep the bin count manageable at 10M+ rows.
GROUP_BITS = 10
GROUP_MASK = jnp.uint32((1 << GROUP_BITS) - 1)
SIGN_U32 = jnp.uint32(0x80000000)
# numpy twins for the Pallas kernel (a kernel cannot close over jnp
# constants); the kernel builds the same u32 keys as the XLA path.
NP_SIGN_U32 = np.uint32(0x80000000)
NP_NOT_GROUP_U32 = np.uint32(0xFFFFFFFF ^ ((1 << GROUP_BITS) - 1))
NP_U32_MAX = np.uint32(0xFFFFFFFF)
BIN_FACTOR = 8
BINS_MIN = 2048
# The scan+select kernel keeps each bin's FOUR smallest keys (top-2 for
# the chunked XLA path above): deeper per-bin capture lets the bin count
# — and with it the key traffic and the decode top_k width — shrink from
# 16*top_c (2 x 8*top_c bins) to 8*top_c (4 x 2*top_c bins) while the
# deepest-rank miss probability IMPROVES from (1/8)^2/2 ~ 0.78% to
# P(Poisson(0.5) >= 4) ~ 0.18%.
FUSED_BIN_FACTOR = 2
FUSED_BINS_MIN = 512
FUSED_TOPM = 4
# Kernel tile: FUSED_BQ query rows x fused_block_bins(P) bins per
# program (4 warps, 3 pipeline stages), the contraction in FUSED_BK-wide
# slices once P exceeds it, so an int8 code tile stays a few KB of
# shared memory at any P.  Bin counts round to FUSED_BN, a multiple of
# every bin block.  Chosen by a tile sweep on an H100 (PERF.md).
FUSED_BQ = 64
FUSED_BN = 64
FUSED_BK = 256
# Score-buffer budget per chunk in f32 elements (Q * chunk <= this) for
# the XLA chunked path.  The peak per chunk is ~2-3x this buffer (the
# int32 fs matmul output materializes alongside the fused score/key
# chain), so 2^28 elements = 1 GB buffer => ~3 GB peak.  The kernel
# path ignores this entirely (no (Q, N) buffer exists).
CHUNK_ELEMENTS = 1 << 28
MIN_CHUNK = 1 << 15
# Chunks are unrolled as static slices inside the jit (one final merge,
# no sequential carry chain) only up to this count; beyond it the
# equal-size chunks roll into a lax.scan that stacks per-chunk
# candidates.  Kept small deliberately: unrolled chunk programs have no
# data dependence, so XLA runs them concurrently and their ~3x
# score-buffer peaks ADD.
MAX_UNROLL = 2


class ScanArrays(NamedTuple):
    """Device-resident folded constants for the scan (built once per
    calibration; see fold_node_constants).

    Codes are stored PACKED as uint32 bit-planes — bits*P/8 bytes per
    vector, the reference's code-memory contract
    (core/codes.hpp:96-135) — and unpacked per chunk right before the
    int8 contraction (ops/pack.unpack_codes_i8); the unpacked int8 tile
    is a transient chunk-sized intermediate, never at-rest state."""

    planes: jax.Array     # (N_pad, B, W) uint32 packed code bit-planes
    node_aux: jax.Array   # (6, N_pad) f32: [nop^2(+pad), nop, g*wpc, g, g*ip_cp, g]
    raw: jax.Array        # (N_pad, P) f32 zero-padded raw vectors
    norm_sq: jax.Array    # (N_pad,)


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def pad_store_and_norms(v, rows: int, cols: int):
    """Zero-pad (n, d) -> (rows, cols) and compute row norms in ONE
    program: fusion keeps the peak at input + output instead of the
    eager pad->pad->square chain's two extra store-sized copies."""
    raw = jnp.pad(
        v.astype(jnp.float32),
        ((0, rows - v.shape[0]), (0, cols - v.shape[1])),
    )
    return raw, jnp.sum(raw * raw, axis=-1)


# rows per encode dispatch (bounds the device-memory transient of the CAQ
# coordinate-descent intermediates during build)
ENCODE_CHUNK = 1 << 17


def encode_scan_store(raw, centroid, signs, bits: int,
                      chunk: int = ENCODE_CHUNK):
    """Encode a padded raw store into the scan representation.

    Returns (planes, nop, ip_qo, ip_cp, wpc) device arrays for all
    raw.shape[0] rows (pad rows encode harmlessly; their node constants
    are overridden by fold_node_constants' PAD_SCORE).  Shared by the
    single-chip finalize and the shard-native sharded build — each shard
    runs this on its own row block.
    """
    rot_centroid = hadamard.rotate(centroid, signs)
    kappa = float((1 << bits) - 1)
    n_rows = raw.shape[0]
    padded = raw.shape[1]
    planes_l, nops, qos, cps, wpcs = [], [], [], [], []
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        enc = quantize.encode_vectors(raw[s:e], centroid, signs, bits)
        cbar = (2.0 * enc.u.astype(jnp.float32) - kappa) / kappa
        ip_cp = jnp.matmul(
            cbar, rot_centroid, precision=jax.lax.Precision.HIGHEST
        ) / jnp.sqrt(float(padded))
        planes_l.append(pack.pack_planes(enc.u, bits))
        nops.append(enc.nop)
        qos.append(enc.ip_qo)
        cps.append(ip_cp)
        wpcs.append(enc.u.sum(axis=-1).astype(jnp.int32))
    cat = jnp.concatenate
    return (cat(planes_l), cat(nops), cat(qos), cat(cps), cat(wpcs))


def store_pad(n: int) -> int:
    """Rows the store is padded to: next multiple of 256.  Keeping the
    dead region tiny matters — the binned-min selection assumes
    winners are spread over the whole row, so a large block of PAD_SCORE
    rows silently degrades its effective recall (measured: 24% pad
    -> recall@top_c 0.90 vs 0.997)."""
    return -(-n // 256) * 256


def chunk_plan(n_pad: int, q: int) -> tuple[int, int, int]:
    """Static chunk plan (chunk_rows, n_equal, remainder_rows).

    chunk_rows keeps the (Q, chunk) score buffer under CHUNK_ELEMENTS;
    the store splits into n_equal chunks of chunk_rows plus one
    remainder chunk (all multiples of 256, all static)."""
    if n_pad <= MIN_CHUNK:
        return n_pad, 1, 0
    chunk = max(MIN_CHUNK, (CHUNK_ELEMENTS // max(q, 1)) // 256 * 256)
    chunk = min(chunk, n_pad)
    n_eq = n_pad // chunk
    rem = n_pad - n_eq * chunk
    return chunk, n_eq, rem


def _chunk_slices(n_pad: int, max_rows: int) -> list[tuple[int, int]]:
    """Static (start, size) chunk slices covering n_pad rows."""
    chunk = min(n_pad, max(256, max_rows // 256 * 256))
    out = [(s, min(chunk, n_pad - s)) for s in range(0, n_pad, chunk)]
    return out


@jax.jit
def fold_node_constants(nop, ip_qo, ip_cp, wpc, ip_qo_floor, n):
    """Fold per-node estimator constants into the rank-5(+g) form.

    Rows pair with the query-side coefficients in _query_side below.
    Rows at index >= n are padding: their score contribution is PAD_SCORE
    so they always rank last.
    """
    n_pad = nop.shape[0]
    qo = jnp.maximum(ip_qo, ip_qo_floor)
    good = qo > EPS_MEDIUM
    g = jnp.where(good, nop / jnp.maximum(qo, EPS_MEDIUM), 0.0)
    valid = jnp.arange(n_pad) < n
    row0 = jnp.where(valid, nop * nop, PAD_SCORE)
    return jnp.stack(
        [
            row0,                              # x 1
            nop,                               # x -2b
            g * wpc.astype(jnp.float32),       # x -2a*B/kappa
            g,                                 # x -2a*C
            g * ip_cp,                         # x +2a
            g,                                 # fs scale (not matmul'd)
        ],
        axis=0,
    )


def _query_side(qpad, signs, affine_a, affine_b, kappa):
    """Encode queries and build the rank-5 coefficient rows + fs weight."""
    qc = quantize.encode_queries(qpad, signs)
    a = jnp.asarray(affine_a, jnp.float32)
    b = jnp.asarray(affine_b, jnp.float32)
    w_fs = -2.0 * a * qc.coeff_a / kappa                       # (Q,)
    ones = jnp.ones_like(qc.coeff_a)
    y_aux = jnp.stack(
        [
            ones,
            -2.0 * b * ones,
            -2.0 * a * qc.coeff_b / kappa,
            -2.0 * a * qc.coeff_c,
            2.0 * a * ones,
        ],
        axis=1,
    )                                                           # (Q, 5)
    return qc, w_fs, y_aux


def _chunk_scores(planes_c, aux_c, q_u_i8, w_fs, y_aux, p):
    """(Q, chunk) folded ranking scores for one packed code chunk.

    fs = <q_u, sum_b 2^(B-1-b) plane_b> — the plane recombination happens
    in the int8 unpack (one fused elementwise kernel) so ONE int8 matmul
    covers every bit width; the reference's per-plane scan + weighted sum
    (fastscan_kernel.hpp:197-217) collapses into the unpack.

    The rank-5 node-constant term is summed as explicit broadcasts, NOT
    a (Q,5)x(5,chunk) matmul: XLA fuses broadcast chains into the
    downstream binned-min reduce without materializing any (Q, chunk)
    buffer, while a dot always materializes its output — at 1M rows
    that is an extra GB-scale HBM round trip per pass."""
    codes_c = pack.unpack_codes_i8(planes_c, p)
    fs = jax.lax.dot_general(
        q_u_i8,
        codes_c,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    g_c = aux_c[5]
    score = (w_fs[:, None] * g_c[None, :]) * fs.astype(jnp.float32)
    for a in range(5):
        score = score + y_aux[:, a, None] * aux_c[a][None, :]
    return score


# --------------------------------------------------------------------------
# Scan+select kernel (Pallas, Triton route): the GPU fast path.
#
# The XLA chunked path writes the int32 fs matrix and re-reads the score
# for both binned-min passes — ~4 device-memory round trips over
# (Q, chunk) 4-byte buffers.  This kernel keeps the (bq, bn) score tile
# in registers and writes only the (Q, 4*bins) packed keys: traffic
# collapses to the int8 codes, re-read once per query block.
#
# Row r of the (groups*bins)-padded store maps to bin r % bins, group
# r // bins — the layout _decode_keys(uniform_bins=bins) decodes.  Grid
# (query blocks, bin blocks); each program walks every group in an
# in-kernel loop, carrying its bins' top-4 keys in registers (one new
# candidate per bin per step: an insertion lattice of 3 min/max pairs
# and a final min), and stores the four key planes once.
# --------------------------------------------------------------------------


def _tile_fs(q_ref, codes_ref, q0, row0, bq: int, bn: int):
    """int32 (bq, bn) tile of fs = <q_u, codes> for query rows
    [q0, q0+bq) and store rows [row0, row0+bn), contracted in a loop
    over FUSED_BK slices once P exceeds it: the compiler pipelines one
    slice's operands, so shared memory stays bounded at any P."""
    import jax.experimental.pallas as pl

    p = codes_ref.shape[1]
    if p <= FUSED_BK:
        return pl.dot(q_ref[pl.ds(q0, bq), :],
                      codes_ref[pl.ds(row0, bn), :], trans_b=True)

    def step(kk, acc):
        k0 = pl.multiple_of(kk * FUSED_BK, FUSED_BK)
        return acc + pl.dot(
            q_ref[pl.ds(q0, bq), pl.ds(k0, FUSED_BK)],
            codes_ref[pl.ds(row0, bn), pl.ds(k0, FUSED_BK)],
            trans_b=True,
        )

    return jax.lax.fori_loop(
        0, p // FUSED_BK, step, jnp.zeros((bq, bn), jnp.int32)
    )


def _fused_kernel(codes_ref, aux_ref, q_ref, wfs_ref, yaux_ref,
                  m1_ref, m2_ref, m3_ref, m4_ref, *, bins: int,
                  groups: int):
    import jax.experimental.pallas as pl

    bq, bn = m1_ref.shape
    q0 = pl.program_id(0) * bq
    col0 = pl.program_id(1) * bn
    w_fs = wfs_ref[pl.ds(q0, bq)]
    y_aux = [yaux_ref[a, pl.ds(q0, bq)] for a in range(5)]

    def body(g, ms):
        row0 = g * bins + col0
        fs = _tile_fs(q_ref, codes_ref, q0, row0, bq, bn)
        g_c = aux_ref[5, pl.ds(row0, bn)]
        score = (w_fs[:, None] * g_c[None, :]) * fs.astype(jnp.float32)
        for a in range(5):
            aux_a = aux_ref[a, pl.ds(row0, bn)]
            score = score + y_aux[a][:, None] * aux_a[None, :]
        u = jax.lax.bitcast_convert_type(score, jnp.uint32)
        key = jnp.where((u & NP_SIGN_U32) != 0, ~u, u | NP_SIGN_U32)
        carry = (key & NP_NOT_GROUP_U32) | g.astype(jnp.uint32)
        out = []
        for m in ms[:-1]:
            out.append(jnp.minimum(m, carry))
            carry = jnp.maximum(m, carry)
        out.append(jnp.minimum(ms[-1], carry))
        return tuple(out)

    init = tuple(
        jnp.full((bq, bn), NP_U32_MAX, jnp.uint32) for _ in range(FUSED_TOPM)
    )
    ms = jax.lax.fori_loop(0, groups, body, init)
    for ref, m in zip((m1_ref, m2_ref, m3_ref, m4_ref), ms):
        ref[...] = m


def derived_sub_batch(n_pad: int, top_c: int, cap: int = 2048) -> int:
    """Search sub-batch size derived from the selection footprint: the
    per-sub-batch device transients scale with sub * bins (the
    FUSED_TOPM key planes, their concat, and the sort scratch of the
    decode top_k, ~24 B per key element end to end).  Bounding them to
    ~1 GB keeps large budgets (the 10M 1-bit store derives ~52k bins)
    from multiplying into the peak; small stores keep the cap, where
    fewer dispatches win."""
    bins = fused_bin_plan(n_pad, top_c)[0]
    sub = cap
    while sub > 256 and sub * bins * 24 > (1 << 30):
        sub //= 2
    return sub


def fused_bin_plan(n_pad: int, top_c: int) -> tuple[int, int, int]:
    """(bins, groups, rows_kpad) for the top-4 kernel over the whole
    store: bins a multiple of the kernel's FUSED_BN bin block, large
    enough for capture (FUSED_BIN_FACTOR * top_c: lambda = top_c/bins
    <= 0.5, so the deepest needed rank survives with P(Poisson(0.5) >= 4)
    ~ 0.2% miss) and for the group-index packing (groups <=
    2^GROUP_BITS)."""
    want = max(
        FUSED_BINS_MIN, FUSED_BIN_FACTOR * top_c,
        -(-n_pad // (1 << GROUP_BITS)),
    )
    block = FUSED_BN
    bins = -(-want // block) * block
    bins = min(bins, -(-n_pad // block) * block)
    groups = -(-n_pad // bins)
    return bins, groups, groups * bins


def use_kernel() -> bool:
    """Whether search takes the scan+select kernel: on the GPU, where it
    compiles through Triton (never interpreted); elsewhere the XLA
    chunked path.  Tests run the kernel in interpret mode explicitly."""
    return jax.default_backend() == "gpu"


def fused_block_bins(p: int) -> int:
    """Bins per kernel program: narrow tiles where the contraction is
    short (more programs in flight), FUSED_BN once it is sliced."""
    return 32 if p <= FUSED_BK else FUSED_BN


def _pallas_compiler_params(interpret: bool):
    """Triton compile parameters for the card; none in interpret mode."""
    if interpret:
        return {}
    from jax.experimental.pallas import triton as pltriton

    return dict(
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3)
    )


def fused_scan_keys(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux,
                    bins: int, interpret: bool = False):
    """(Q, FUSED_TOPM*bins) packed top-4 bin keys (u32, _decode_keys'
    convention) over the kernel-padded store (rows_kpad = groups*bins
    rows).  interpret=True runs the kernel in the Pallas interpreter
    (CPU tests); otherwise it compiles through Triton for the GPU."""
    import jax.experimental.pallas as pl

    rows_kpad, p = codes_i8.shape
    q = q_u_i8.shape[0]
    if bins % FUSED_BN or rows_kpad % bins:
        raise ValueError(f"bins={bins} does not tile {rows_kpad} rows")
    groups = rows_kpad // bins
    bq, bn = FUSED_BQ, fused_block_bins(p)
    q_pad = -(-q // bq) * bq
    if q_pad != q:
        q_u_i8 = jnp.pad(q_u_i8, ((0, q_pad - q), (0, 0)))
        w_fs = jnp.pad(w_fs, (0, q_pad - q))
        y_aux = jnp.pad(y_aux, ((0, q_pad - q), (0, 0)))
    kernel = functools.partial(_fused_kernel, bins=bins, groups=groups)
    ms = pl.pallas_call(
        kernel,
        grid=(q_pad // bq, bins // bn),
        # whole-array inputs: each program indexes its own rows
        in_specs=[pl.BlockSpec() for _ in range(5)],
        out_specs=[
            pl.BlockSpec((bq, bn), lambda qi, bj: (qi, bj))
            for _ in range(FUSED_TOPM)
        ],
        out_shape=[
            jax.ShapeDtypeStruct((q_pad, bins), jnp.uint32)
            for _ in range(FUSED_TOPM)
        ],
        backend="triton",
        interpret=interpret,
        name="scan_select",
        **_pallas_compiler_params(interpret),
    )(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux.T)
    return jnp.concatenate(ms, axis=1)[:q]


def _fs_kernel(codes_ref, q_ref, fs_ref):
    import jax.experimental.pallas as pl

    bq, bn = fs_ref.shape
    fs_ref[...] = _tile_fs(q_ref, codes_ref, pl.program_id(0) * bq,
                           pl.program_id(1) * bn, bq, bn)


def fused_fs(codes_i8, q_u_i8, interpret: bool = False):
    """(Q, rows) int32 fs through the kernel's own tile product — the
    check that its int8 contraction equals XLA's bit for bit, on the
    search's own tile.  Q and rows must be multiples of FUSED_BQ and
    FUSED_BN."""
    import jax.experimental.pallas as pl

    rows, p = codes_i8.shape
    q = q_u_i8.shape[0]
    bn = fused_block_bins(p)
    return pl.pallas_call(
        _fs_kernel,
        grid=(q // FUSED_BQ, rows // bn),
        in_specs=[pl.BlockSpec(), pl.BlockSpec()],
        out_specs=pl.BlockSpec((FUSED_BQ, bn), lambda qi, bj: (qi, bj)),
        out_shape=jax.ShapeDtypeStruct((q, rows), jnp.int32),
        backend="triton",
        interpret=interpret,
        name="scan_fs_tile",
        **_pallas_compiler_params(interpret),
    )(codes_i8, q_u_i8)


# Gathered-candidate f32 elements per rerank piece (Q * piece * P): the
# (Q, C, P) gather at large C and P would dominate memory (e.g. 1M/960d at
# k=100 derives C in the thousands -> an 8 GB gather); chunking candidates
# with a running top-k merge bounds it at ~1 GB.
RERANK_ELEMENTS = 1 << 28
# Candidate count above which the rerank goes two-stage: a reduced-
# precision distance pass over all C candidates selects
# RERANK_SURVIVORS(k) survivors which then get the exact f32 rerank.
# The stage-1 "sketch" store is bf16 (half the f32 gather traffic) when
# the extra copy is small, else int8 with per-dimension scales (1/4 the
# traffic AND 1/4 the at-rest bytes).  Reduced precision can only cost
# recall if a true top-k candidate misranks below ~4k other candidates
# in stage 1 — far outside either dtype's error bar — while the final
# distances stay exact f32.  Below the threshold the single-stage f32
# path is exact.
TWO_STAGE_MIN_C = 4096
# bf16 sketch only while the raw store itself is small enough that a
# half-size copy is noise; beyond this the int8 sketch takes over.
BF16_SKETCH_MAX_RAW_BYTES = 3 << 30


class RerankSketch(NamedTuple):
    """Reduced-precision stage-1 rerank store (see TWO_STAGE_MIN_C).

    store: (N_pad, P) bf16, or int8 codes with per-dim scales;
    norm_sq: (N_pad,) f32 squared norms OF THE SKETCH points;
    scale:   None for bf16, (P,) f32 dequant scales for int8."""

    store: jax.Array
    norm_sq: jax.Array
    scale: jax.Array | None


@jax.jit
def _sketch_bf16(raw, norm_sq):
    return RerankSketch(raw.astype(jnp.bfloat16), norm_sq, None)


def make_rerank_sketch(raw, norm_sq, force_int8: bool = False
                       ) -> RerankSketch:
    """Build the stage-1 sketch for a raw store (device programs only;
    row-chunked so no f32-sized transient materializes).  force_int8
    requests the int8 form regardless of size (the sketch-scan mode
    needs an int8 matmul operand)."""
    if not force_int8 and raw.nbytes <= BF16_SKETCH_MAX_RAW_BYTES:
        return _sketch_bf16(raw, norm_sq)

    @jax.jit
    def dim_scale(raw):
        return jnp.maximum(jnp.max(jnp.abs(raw), axis=0), 1e-12) / 127.0

    @functools.partial(jax.jit, donate_argnums=())
    def quant_chunk(raw_c, scale):
        codes = jnp.clip(
            jnp.round(raw_c / scale[None, :]), -127, 127
        ).astype(jnp.int8)
        xhat = codes.astype(jnp.float32) * scale[None, :]
        return codes, jnp.sum(xhat * xhat, axis=-1)

    scale = dim_scale(raw)
    n_pad = raw.shape[0]
    step = 1 << 20
    codes_l, norms_l = [], []
    for s in range(0, n_pad, step):
        c, nsq = quant_chunk(
            jax.lax.slice_in_dim(raw, s, min(s + step, n_pad), axis=0),
            scale,
        )
        codes_l.append(c)
        norms_l.append(nsq)
    return RerankSketch(
        jnp.concatenate(codes_l), jnp.concatenate(norms_l), scale
    )


def _rerank_survivors(k: int, c: int) -> int:
    # floor 512: the int8 sketch's QUERY-side quantization noise (the
    # round(q*scale/sigma_q) operand) can push a true top-10 neighbor
    # to sketch rank ~300+ on wide-gap clustered data; the stage-2 exact
    # gather of 512 rows/query is small next to the store stream
    return min(max(4 * k, 512), c)


def _candidate_topk(raw, norm_sq, qeff, qnorm, cand_ids, n, kk: int,
                    elems: int):
    """Top-kk of gathered-candidate L2 distances, pieces bounded by
    `elems` gathered elements; returns (neg_dists (Q, kk), ids (Q, kk)).
    dtype of `raw` sets the GATHER precision (f32 exact / bf16 / int8
    sketch — the gather traffic is the cost, so low-precision rows are
    upcast to the query dtype only after the gather, in-register);
    distances accumulate in f32 either way.  `qeff` is the caller-
    prepared query operand (scale-folded for the int8 sketch)."""
    q, c = cand_ids.shape
    p = raw.shape[1]
    piece = max(kk, elems // max(q * p, 1))

    def block(ids_blk):
        vecs = raw[ids_blk]                                    # (Q, c_b, P)
        if vecs.dtype != qeff.dtype:
            vecs = vecs.astype(qeff.dtype)
        norms = norm_sq[ids_blk]
        exact = estimate.exact_l2_sq(qeff, qnorm, vecs, norms)
        return jnp.where(ids_blk < n, exact, FLOAT_MAX)

    if piece >= c:
        neg_d, idx = jax.lax.top_k(-block(cand_ids), kk)
        ids = jnp.take_along_axis(cand_ids, idx, axis=1)
        return neg_d, ids
    # lax.scan (NOT an unrolled python loop): the piece gathers have
    # no data dependence on each other, so unrolled XLA schedules
    # them all concurrently — a dozen 1 GB gathers OOM the chip at
    # 1M x 1024d.  scan's sequential carry bounds live memory to ~one
    # piece.  Pad with an out-of-range id: the gather clamps, the
    # n-mask prices it FLOAT_MAX, the final mask maps it to -1.
    n_pieces = -(-c // piece)
    pad_c = n_pieces * piece - c
    ids_pad = cand_ids
    if pad_c:
        ids_pad = jnp.concatenate(
            [cand_ids, jnp.full((q, pad_c), jnp.int32(2**30))], axis=1
        )
    blocks = ids_pad.reshape(q, n_pieces, piece).transpose(1, 0, 2)

    def body(carry, blk):
        best_neg, best_ids = carry
        neg = -block(blk)
        cat_neg = jnp.concatenate([best_neg, neg], axis=1)
        cat_ids = jnp.concatenate([best_ids, blk], axis=1)
        best_neg, sel = jax.lax.top_k(cat_neg, kk)
        best_ids = jnp.take_along_axis(cat_ids, sel, axis=1)
        return (best_neg, best_ids), None

    (neg_d, ids), _ = jax.lax.scan(
        body,
        (jnp.full((q, kk), -FLOAT_MAX), jnp.zeros((q, kk), jnp.int32)),
        blocks,
    )
    return neg_d, ids


def _rerank(raw, norm_sq, qpad, qnorm, cand_ids, n, k, sketch=None):
    """Exact-L2 rerank of gathered candidates; pad candidates -> FLOAT_MAX.

    With a RerankSketch and a large candidate set, the rerank goes
    two-stage: reduced-precision distances select survivors, the exact
    f32 pass runs only on those (the 10M 1-bit budget derives C in the
    tens of thousands — a 13.7 GB f32 gather per 1024 queries that the
    sketch cuts 2x/4x, with the f32 stage collapsing to k-scale).
    """
    c = cand_ids.shape[1]
    if sketch is not None and c >= TWO_STAGE_MIN_C:
        surv = _rerank_survivors(k, c)
        if sketch.scale is None:          # bf16 sketch
            qeff = qpad.astype(jnp.bfloat16)
            elems = 2 * RERANK_ELEMENTS
        else:                             # int8 sketch: fold the scales
            qeff = qpad * sketch.scale[None, :]
            elems = 4 * RERANK_ELEMENTS
        _, cand_ids = _candidate_topk(
            sketch.store, sketch.norm_sq, qeff, qnorm, cand_ids, n,
            surv, elems,
        )
    neg_d, ids = _candidate_topk(
        raw, norm_sq, qpad, qnorm, cand_ids, n, k, RERANK_ELEMENTS
    )
    ids = jnp.where(neg_d > -FLOAT_MAX, ids, -1)
    return ids, -neg_d


def _select(score, top_c: int, exact: bool):
    """Per-chunk EXACT candidate selection (test/reference path; the fast
    path is the binned-min reduce below)."""
    del exact
    return jax.lax.top_k(-score, min(top_c, score.shape[1]))


def _bin_plan(size: int, want_bins: int) -> tuple[int, int]:
    """(group, bins) for the binned-min reduce over a `size`-row chunk.

    bins >= want_bins (capture), group <= 2^GROUP_BITS (the group index
    must pack into the low key bits), group a power of two so it divides
    size (all chunk sizes are multiples of 256)."""
    if want_bins >= size:
        return 1, size
    g = min(size // want_bins, 1 << GROUP_BITS)
    g = 1 << (g.bit_length() - 1)
    while size % g:  # largest power of two that divides size
        g >>= 1
    return g, size // g


def _monotone_u32(score):
    """Order-preserving f32 -> u32 key map (IEEE sign-magnitude trick)."""
    u = jax.lax.bitcast_convert_type(score, jnp.uint32)
    return jnp.where((u & SIGN_U32) != 0, ~u, u | SIGN_U32)


def _binned_keys(score, g: int, bins: int):
    """(Q, 2*bins) packed keys: each bin's TWO smallest score keys, the
    winning group index in the low GROUP_BITS of each.  Row index within
    the chunk decodes as group_idx * bins + bin_idx.  Keys are unique
    within a bin (distinct group indices), so the masked re-reduce
    yields the exact second minimum."""
    q = score.shape[0]
    if g == 1:
        # exact per-row path: keep FULL key precision (no group index
        # needed — callers decode g==1 chunks with stride 0, so the low
        # bits never reach the id arithmetic).  Masking here would
        # create estimate ties that break the "per-shard selection is a
        # superset of global" exactness the sharded merge relies on.
        return _monotone_u32(score)
    keys = (_monotone_u32(score) & ~GROUP_MASK).reshape(q, g, bins)
    gidx = jax.lax.broadcasted_iota(jnp.uint32, (q, g, bins), 1)
    keys = keys | gidx
    m1 = jnp.min(keys, axis=1)
    if g == 2:  # the two entries ARE the top-2
        m2 = jnp.max(keys, axis=1)
    else:
        m2 = jnp.min(
            jnp.where(keys == m1[:, None, :], jnp.uint32(0xFFFFFFFF), keys),
            axis=1,
        )
    return jnp.concatenate([m1, m2], axis=1)


def _decode_keys(cat_key, bin_base, bin_stride, top_c: int,
                 uniform_bins: int | None = None):
    """Pick the smallest top_c keys across all bins, decode to row ids.

    The kept keys are reconstructed from lax.top_k's VALUES (the
    unsigned->signed map is a bijection) instead of a (Q, top_c)
    take_along_axis gather.  When
    `uniform_bins` is given (the fused whole-store layout: bin_base =
    tile(arange(bins), m), stride = bins everywhere) the base/stride
    lookups collapse to arithmetic on `keep` and no gather remains.
    """
    w = cat_key.shape[1]
    tc = min(top_c, w)
    # unsigned-ascending -> signed-descending so lax.top_k picks minima
    sel_key = jax.lax.bitcast_convert_type(~cat_key ^ SIGN_U32, jnp.int32)
    if tc < w:
        v, keep = jax.lax.top_k(sel_key, tc)
        kept = ~jax.lax.bitcast_convert_type(v, jnp.uint32) ^ SIGN_U32
    else:
        keep = jnp.broadcast_to(
            jnp.arange(w, dtype=jnp.int32), cat_key.shape
        )
        kept = cat_key
    gi = (kept & GROUP_MASK).astype(jnp.int32)
    if uniform_bins is not None:
        return gi * jnp.int32(uniform_bins) + keep % jnp.int32(uniform_bins)
    return gi * bin_stride[keep] + bin_base[keep]


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "top_c", "chunk", "n_eq", "rem", "exact_select", "fused",
        "interpret",
    ),
)
def scan_search(
    arrays: ScanArrays,
    queries: jax.Array,
    signs: jax.Array,
    affine_a,
    affine_b,
    n,
    kappa: float,
    k: int,
    top_c: int,
    chunk: int,
    n_eq: int = 1,
    rem: int = 0,
    exact_select: bool = False,
    fused: bool = False,
    interpret: bool = False,
    sketch=None,
):
    """Estimate-scan all N codes, select top_c, exact-rerank to top k.

    queries: (Q, dim<=P) raw; returns (ids (Q,k) int32 global, d (Q,k)).
    (chunk, n_eq, rem) is the static chunk plan from chunk_plan().
    Chunks are independent (per-chunk binned-min keys, one global decode
    at the end) — no sequential carry chain across chunks.  All heavy
    arrays are jit ARGUMENTS (a closure capture would be embedded in the
    program as a constant).  fused=True takes the scan+select kernel
    (compiled for the GPU; interpret=True runs it in the Pallas
    interpreter instead); with an int8 `sketch` it runs the sketch-scan
    mode.
    """
    n_pad, p = arrays.raw.shape
    assert n_eq * chunk + rem == n_pad
    qpad = hadamard.pad_to(queries.astype(jnp.float32), p)
    qnorm = jnp.sum(qpad * qpad, axis=-1)
    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    q_u_i8 = qc.q_u.astype(jnp.int8)

    q = qpad.shape[0]

    def chunk_score(start, size):
        planes_c = jax.lax.slice_in_dim(arrays.planes, start,
                                        start + size, axis=0)
        aux_c = jax.lax.slice_in_dim(arrays.node_aux, start,
                                     start + size, axis=1)
        return _chunk_scores(planes_c, aux_c, q_u_i8, w_fs, y_aux, p)

    if exact_select:
        # reference-exact selection for tests: full top_k per chunk + merge
        parts_neg, parts_ids = [], []
        for start in range(0, n_pad, chunk):
            size = min(chunk, n_pad - start)
            neg, idx = _select(chunk_score(start, size), top_c, True)
            parts_neg.append(neg)
            parts_ids.append(idx.astype(jnp.int32) + start)
        cat_neg = jnp.concatenate(parts_neg, axis=1)
        cat_ids = jnp.concatenate(parts_ids, axis=1)
        if cat_neg.shape[1] > top_c:
            _, keep = jax.lax.top_k(cat_neg, top_c)
            cand_ids = jnp.take_along_axis(cat_ids, keep, axis=1)
        else:
            cand_ids = cat_ids
        return _rerank(
            arrays.raw, arrays.norm_sq, qpad, qnorm,
            cand_ids.astype(jnp.int32), n, k, sketch=sketch,
        )

    if fused and sketch is not None and sketch.scale is not None:
        # --- Sketch-scan mode: instead of selecting top_c by ESTIMATE
        # and gathering top_c rows per query (at the 10M 1-bit budget,
        # top_c ~26k, Q*top_c gathered rows approach the store size and
        # random row gathers run far below streaming bandwidth), stream
        # the int8 sketch store through the SAME kernel with near-exact
        # distances.  The kernel algebra is reused verbatim:
        #   score = ||x_hat||^2 - 2*sigma_q*<q8, codes>   with
        #   q8 = round(q*scale/sigma_q)  (int8 matmul operand)
        # i.e. aux row0 = sketch norms (PAD_SCORE on pad rows), row5 = 1,
        # w_fs = -2*sigma_q, y_aux = e0.  Survivors get the exact f32
        # rerank, so the output contract is unchanged.
        surv = _rerank_survivors(k, top_c)
        bins, groups, rows_kpad = fused_bin_plan(n_pad, surv)
        codes_s = sketch.store
        norm_s = jnp.where(
            jnp.arange(n_pad) < n, sketch.norm_sq, PAD_SCORE
        )
        if rows_kpad != n_pad:
            padr = rows_kpad - n_pad
            codes_s = jnp.pad(codes_s, ((0, padr), (0, 0)))
            norm_s = jnp.pad(norm_s, (0, padr),
                             constant_values=PAD_SCORE)
        zeros = jnp.zeros_like(norm_s)
        aux_s = jnp.stack(
            [norm_s, zeros, zeros, zeros, zeros, jnp.ones_like(norm_s)], 0
        )
        q_scaled = qpad * sketch.scale[None, :]
        sigma_q = jnp.maximum(
            jnp.max(jnp.abs(q_scaled), axis=1), 1e-12
        ) / 127.0
        q8 = jnp.clip(
            jnp.round(q_scaled / sigma_q[:, None]), -127, 127
        ).astype(jnp.int8)
        w_fs_s = -2.0 * sigma_q
        y_aux_s = jnp.concatenate(
            [jnp.ones((q, 1), jnp.float32),
             jnp.zeros((q, 4), jnp.float32)], axis=1
        )
        cat_key = fused_scan_keys(
            codes_s, aux_s, q8, w_fs_s, y_aux_s, bins,
            interpret=interpret,
        )
        cand_ids = _decode_keys(cat_key, None, None, surv,
                                uniform_bins=bins)
        return _rerank(
            arrays.raw, arrays.norm_sq, qpad, qnorm,
            cand_ids.astype(jnp.int32), n, k,
        )

    if fused:
        # --- kernel path: whole store in one kernel, no chunking (no
        # (Q, N) buffer ever exists, so CHUNK_ELEMENTS is moot) ---
        bins, groups, rows_kpad = fused_bin_plan(n_pad, top_c)
        planes_k = arrays.planes
        aux_k = arrays.node_aux
        if rows_kpad != n_pad:
            padr = rows_kpad - n_pad
            # pad the PACKED planes (32x smaller) before unpacking so
            # only one store-sized int8 buffer ever exists
            planes_k = jnp.pad(planes_k, ((0, padr), (0, 0), (0, 0)))
            # kernel-pad rows rank last through the additive aux row 0
            aux_k = jnp.pad(aux_k, ((0, 0), (0, padr)))
            aux_k = aux_k.at[0, n_pad:].set(PAD_SCORE)
        codes_i8 = pack.unpack_codes_i8(planes_k, p)
        cat_key = fused_scan_keys(
            codes_i8, aux_k, q_u_i8, w_fs, y_aux, bins,
            interpret=interpret,
        )
        cand_ids = _decode_keys(
            cat_key, None, None, top_c, uniform_bins=bins
        )
        # ids in [n, rows_kpad) decode from pad rows; _rerank prices any
        # id >= n at FLOAT_MAX and maps it to -1
        return _rerank(
            arrays.raw, arrays.norm_sq, qpad, qnorm,
            cand_ids.astype(jnp.int32), n, k, sketch=sketch,
        )

    # --- fast path: fused binned-min keys per chunk, one global decode ---
    total_chunks = n_eq + (1 if rem else 0)
    want = max(BINS_MIN, BIN_FACTOR * top_c)
    want_c = -(-want // total_chunks)  # capture depends on TOTAL bins
    g_eq, bins_eq = _bin_plan(chunk, want_c)
    keys_parts, base_parts, stride_parts = [], [], []
    # g > 1 chunks emit [bin minima, bin second-minima] — two key blocks
    # sharing the same (base, stride) decode arrays
    lane_eq = np.tile(
        np.arange(bins_eq, dtype=np.int32), 1 if g_eq == 1 else 2
    )
    stride_eq = np.full(lane_eq.shape, 0 if g_eq == 1 else bins_eq,
                        np.int32)

    def eq_chunk_keys(start):
        return _binned_keys(chunk_score(start, chunk), g_eq, bins_eq)

    if n_eq <= MAX_UNROLL:
        for c in range(n_eq):
            keys_parts.append(eq_chunk_keys(c * chunk))
            base_parts.append(c * chunk + lane_eq)
            stride_parts.append(stride_eq)
    else:
        b, w = arrays.planes.shape[1:]
        planes = arrays.planes[: n_eq * chunk].reshape(n_eq, chunk, b, w)
        aux = (arrays.node_aux[:, : n_eq * chunk]
               .reshape(6, n_eq, chunk).transpose(1, 0, 2))

        def body(_, xs):
            planes_c, aux_c = xs
            score = _chunk_scores(planes_c, aux_c, q_u_i8, w_fs, y_aux, p)
            return None, _binned_keys(score, g_eq, bins_eq)

        _, keys_s = jax.lax.scan(body, None, (planes, aux))
        keys_parts.append(keys_s.transpose(1, 0, 2).reshape(q, -1))
        for c in range(n_eq):
            base_parts.append(c * chunk + lane_eq)
            stride_parts.append(stride_eq)

    if rem:
        g_r, bins_r = _bin_plan(rem, want_c)
        keys_parts.append(
            _binned_keys(chunk_score(n_eq * chunk, rem), g_r, bins_r)
        )
        lane_r = np.tile(
            np.arange(bins_r, dtype=np.int32), 1 if g_r == 1 else 2
        )
        base_parts.append(n_eq * chunk + lane_r)
        stride_parts.append(
            np.full(lane_r.shape, 0 if g_r == 1 else bins_r, np.int32)
        )

    cat_key = (keys_parts[0] if len(keys_parts) == 1
               else jnp.concatenate(keys_parts, axis=1))
    bin_base = jnp.asarray(np.concatenate(base_parts))
    bin_stride = jnp.asarray(np.concatenate(stride_parts))
    cand_ids = _decode_keys(cat_key, bin_base, bin_stride, top_c)

    return _rerank(
        arrays.raw, arrays.norm_sq, qpad, qnorm,
        cand_ids.astype(jnp.int32), n, k, sketch=sketch,
    )


def calibration_samples(
    raw: jax.Array,
    planes: jax.Array,
    nop: jax.Array,
    ip_qo: jax.Array,
    ip_cp: jax.Array,
    wpc: jax.Array,
    centroid: jax.Array,
    signs: jax.Array,
    n: int,
    bits: int,
    num_samples: int = 2000,
    seed: int = 99999,
) -> dict:
    """Estimator calibration sample pairs from ONE store (or one shard).

    Samples database rows as queries and random rows as targets, and
    returns the host-side raw material the affine fit consumes:
    {ip_approx, ip_qo, ip_cp, nop, true_ip} (each (num_samples,)).
    Shards pool these before fitting (fit_scan_affine) — the fit then
    sees the same pair distribution as a single-chip calibration.
    """
    rng = np.random.default_rng(seed)
    n_s = min(num_samples, n)
    q_ids = rng.choice(n, size=n_s, replace=False)
    x_ids = rng.integers(0, n, size=n_s)

    # numpy indexers (NOT jnp.asarray) so the gathers stay on the data's
    # own device — the sharded build runs this per shard on that shard's
    # mesh device, and a default-device-committed indexer would clash
    qvecs = raw[q_ids]
    qc = quantize.encode_queries(qvecs, signs)
    codes = pack.unpack_planes(planes[x_ids], raw.shape[1])
    fs = jnp.einsum("sp,sp->s", qc.q_u, codes)
    kappa = float((1 << bits) - 1)
    ip_approx = estimate.ip_from_fastscan(
        fs, wpc[x_ids], qc.coeff_a, qc.coeff_b, qc.coeff_c,
        kappa,
    )
    ip_qo_s = np.asarray(ip_qo)[x_ids]
    ip_cp_s = np.asarray(ip_cp)[x_ids]
    nop_s = np.asarray(nop)[x_ids]

    centroid_h = np.asarray(centroid)
    xvecs = np.asarray(raw[x_ids])
    qv = np.asarray(qvecs)
    true_ip = ((qv - centroid_h) * (xvecs - centroid_h)).sum(-1) / np.maximum(
        nop_s, 1e-12
    )
    return dict(
        ip_approx=np.asarray(ip_approx), ip_qo=ip_qo_s, ip_cp=ip_cp_s,
        nop=nop_s, true_ip=true_ip,
    )


def fit_scan_affine(samples: list[dict]) -> tuple[float, float, float]:
    """Huber-fit the affine estimator correction from pooled calibration
    samples (reference calibrate_estimator, api/hnsw_index.hpp:718-1017:
    affine (a, b) + MAD-fence ip_qo_floor).  Pooling the raw pairs over
    shards (instead of median-of-fits) keeps the fit identical in law to
    a single-chip calibration over the union sample."""
    from cphnsw_tpu.calibration import huber

    pool = {
        k: np.concatenate([s[k] for s in samples])
        for k in samples[0]
    }
    ip_qo_floor = huber.mad_lower_fence(np.abs(pool["ip_qo"]))
    denom = np.maximum(np.abs(pool["ip_qo"]), max(ip_qo_floor, 1e-12))
    raw_est = (pool["ip_approx"] - pool["ip_cp"]) / denom
    good = pool["nop"] > 1e-6
    a, b, _ = huber.fit_affine_huber(
        raw_est[good], pool["true_ip"][good]
    )
    return float(a), float(b), float(ip_qo_floor)


def calibrate_scan_affine(
    raw: jax.Array,
    planes: jax.Array,
    nop: jax.Array,
    ip_qo: jax.Array,
    ip_cp: jax.Array,
    wpc: jax.Array,
    centroid: jax.Array,
    signs: jax.Array,
    n: int,
    bits: int,
    num_samples: int = 2000,
    seed: int = 99999,
):
    """Affine estimator correction for the scan path: single-store
    composition of calibration_samples + fit_scan_affine.  Returns
    (affine_a, affine_b, ip_qo_floor) floats."""
    s = calibration_samples(
        raw, planes, nop, ip_qo, ip_cp, wpc, centroid, signs, n, bits,
        num_samples=num_samples, seed=seed,
    )
    return fit_scan_affine([s])


# --------------------------------------------------------------------------
# Build-time candidate-budget derivation (the parameterless contract):
# measure, on calibration queries, the rank EACH true top-k neighbor gets
# under the ESTIMATE ordering, and set top_c as the tail quantile of that
# per-neighbor rank distribution — capture fraction ~= expected recall,
# so quantile 0.99 targets recall ~0.99 (the full-capture max-rank
# variant overshoots ~3x for the same recall).  Query recipe mirrors
# calibrate_estimator's (database rows + sigma-jittered synthetics,
# reference api/hnsw_index.hpp:873-890).
# --------------------------------------------------------------------------

RANK_QUANTILE = 0.99
RANK_SAFETY = 1.1
RANK_ANCHORS = (1, 10, 100)


class CandidateBudget(NamedTuple):
    anchors: np.ndarray   # (A,) k values
    ranks: np.ndarray     # (A,) derived top_c at each anchor

    def top_c(self, k: int, n: int) -> int:
        """Log-log interpolate/extrapolate the derived budget to k."""
        la = np.log(self.anchors.astype(np.float64))
        lr = np.log(np.maximum(self.ranks.astype(np.float64), 1.0))
        c = float(np.exp(np.interp(np.log(max(k, 1)), la, lr)))
        if k > self.anchors[-1]:
            # extrapolate with the last segment's slope
            if len(self.anchors) > 1:
                slope = (lr[-1] - lr[-2]) / max(la[-1] - la[-2], 1e-9)
            else:
                slope = 1.0
            c = float(np.exp(lr[-1] + slope * (np.log(k) - la[-1])))
        c = int(np.ceil(c / 32.0) * 32)
        return int(np.clip(c, min(4 * k, n), n))


@functools.partial(jax.jit, static_argnames=("k",))
def _true_topk_chunked(raw, norm_sq, qpad, qnorm, n, k):
    """Exact top-k (ids, dists) over the padded store, in static chunks."""
    n_pad, p = raw.shape
    q = qpad.shape[0]
    max_rows = max(MIN_CHUNK, CHUNK_ELEMENTS // max(q, 1))
    parts_neg, parts_ids = [], []
    for start, size in _chunk_slices(n_pad, max_rows):
        vecs = jax.lax.slice_in_dim(raw, start, start + size, axis=0)
        norms = jax.lax.slice_in_dim(norm_sq, start, start + size, axis=0)
        dots = jnp.matmul(qpad, vecs.T, precision=jax.lax.Precision.HIGHEST)
        d = qnorm[:, None] + norms[None, :] - 2.0 * dots
        ids_local = jnp.arange(size, dtype=jnp.int32) + start
        d = jnp.where(ids_local[None, :] < n, d, FLOAT_MAX)
        neg, idx = jax.lax.top_k(-d, min(k, size))
        parts_neg.append(neg)
        parts_ids.append(ids_local[idx])
    cat_neg = jnp.concatenate(parts_neg, axis=1)
    cat_ids = jnp.concatenate(parts_ids, axis=1)
    if cat_neg.shape[1] > k:
        neg, keep = jax.lax.top_k(cat_neg, k)
        return jnp.take_along_axis(cat_ids, keep, axis=1), -neg
    return cat_ids, -cat_neg


@functools.partial(jax.jit, static_argnames=("kappa",))
def est_scores_of(
    arrays: ScanArrays,
    qpad,
    ids,             # (Q, T) LOCAL row ids to score
    signs,
    affine_a,
    affine_b,
    kappa: float,
):
    """Folded ranking score of specific store rows per query (Q, T) —
    the same quantity _chunk_scores computes for whole chunks, gathered
    for arbitrary rows.  The sharded budget derivation scores each true
    neighbor on its home shard with this."""
    n_pad, p = arrays.raw.shape
    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    codes_t = pack.unpack_planes(arrays.planes[ids], p)       # (Q, T, P)
    fs_t = jnp.einsum(
        "qtp,qp->qt", codes_t, qc.q_u.astype(jnp.int32)
    ).astype(jnp.float32)
    aux_t = arrays.node_aux[:, ids]                           # (6, Q, T)
    # f32 products, as _chunk_scores' broadcasts: the thresholds must
    # rank exactly like the chunk scores count_leq compares them with
    const_t = jnp.einsum("qa,aqt->qt", y_aux, aux_t[:5],
                         precision=jax.lax.Precision.HIGHEST)
    return const_t + w_fs[:, None] * aux_t[5] * fs_t          # (Q, T)


@functools.partial(jax.jit, static_argnames=("kappa",))
def count_leq(
    arrays: ScanArrays,
    qpad,
    est_t,           # (Q, T) score thresholds
    signs,
    affine_a,
    affine_b,
    kappa: float,
):
    """Per (query, threshold): #store rows whose folded score <= est_t.
    Summed across shards this is the global estimate rank of each
    threshold row — the candidate-list size needed to capture it."""
    n_pad, p = arrays.raw.shape
    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    q_u_i8 = qc.q_u.astype(jnp.int8)

    # bound the (Q, T, chunk) bool comparison buffer to ~1 GB; chunks
    # roll through a lax.scan (an unrolled python loop would inline
    # hundreds of chunk bodies at 10M rows and explode compile time)
    q, t = est_t.shape
    max_rows = max(256, (1 << 30) // max(q * t, 1))
    cs = min(n_pad, max_rows // 256 * 256)
    n_eqc = n_pad // cs
    rem = n_pad - n_eqc * cs
    counts = jnp.zeros(est_t.shape, jnp.int32)

    def count_in(score):
        return jnp.sum(
            score[:, None, :] <= est_t[:, :, None], axis=2,
            dtype=jnp.int32,
        )

    if n_eqc > 0:
        b, w = arrays.planes.shape[1:]
        planes_s = arrays.planes[: n_eqc * cs].reshape(n_eqc, cs, b, w)
        aux_s = (arrays.node_aux[:, : n_eqc * cs]
                 .reshape(6, n_eqc, cs).transpose(1, 0, 2))

        def body(acc, xs):
            planes_c, aux_c = xs
            score = _chunk_scores(planes_c, aux_c, q_u_i8, w_fs, y_aux, p)
            return acc + count_in(score), None

        counts, _ = jax.lax.scan(body, counts, (planes_s, aux_s))
    if rem:
        planes_c = jax.lax.slice_in_dim(arrays.planes, n_eqc * cs,
                                        n_pad, axis=0)
        aux_c = jax.lax.slice_in_dim(arrays.node_aux, n_eqc * cs,
                                     n_pad, axis=1)
        score = _chunk_scores(planes_c, aux_c, q_u_i8, w_fs, y_aux, p)
        counts = counts + count_in(score)
    return counts


def derive_candidate_budget(
    arrays: ScanArrays,
    signs: jax.Array,
    affine_a: float,
    affine_b: float,
    n: int,
    kappa: float,
    seed: int,
    n_queries: int = 256,
) -> CandidateBudget:
    """Measure the estimate-rank tail of true neighbors; derive top_c.

    top_c(k) = ceil(quantile_{0.99}(per-neighbor est rank over true
    top-k) * 1.1) — the capture fraction of the candidate set IS the
    expected recall, so this targets recall ~= RANK_QUANTILE.  The
    scan-mode analog of the reference's EVT-derived beam gates: no
    user-facing knob, everything from the index's own data.

    Query model, two cohorts measured separately with the per-anchor MAX
    taken (robustness to out-of-distribution queries without overshooting
    the in-distribution budget):
      * NEAR — database rows jittered at each row's own true
        nearest-neighbor distance, the data's intrinsic
        query-displacement scale;
      * FAR — a held-out cohort jittered at 3x that distance, standing
        in for genuinely out-of-distribution queries whose estimate-rank
        tails are heavier (their true neighbors sit deeper in the
        estimate ordering).
    (Full-dimension sigma jitter, the reference's calibration recipe,
    lands between clusters and overshoots the budget ~2x.)
    """
    rng = np.random.default_rng(seed)
    m = int(min(n_queries, n))
    ids = rng.choice(n, size=m, replace=False)
    db_rows = np.asarray(arrays.raw[jnp.asarray(ids)])
    rows_j = jnp.asarray(db_rows)
    rows_norm = jnp.sum(rows_j * rows_j, axis=-1)
    _, d2 = _true_topk_chunked(
        arrays.raw, arrays.norm_sq, rows_j, rows_norm,
        jnp.asarray(n), min(2, n),
    )
    nn_dist = np.sqrt(np.maximum(np.asarray(d2)[:, -1], 0.0))  # excl. self
    p = db_rows.shape[1]

    anchors = sorted({min(a, n) for a in RANK_ANCHORS})
    k_max = anchors[-1]
    per_cohort = []
    for scale in (1.0, 3.0):
        noise = rng.standard_normal((m, p)).astype(np.float32) / np.sqrt(p)
        queries = db_rows + noise * (scale * nn_dist)[:, None]
        qpad = jnp.asarray(queries)
        qnorm = jnp.sum(qpad * qpad, axis=-1)
        true_ids, _ = _true_topk_chunked(
            arrays.raw, arrays.norm_sq, qpad, qnorm, jnp.asarray(n), k_max
        )
        a_dev = jnp.asarray(affine_a, jnp.float32)
        b_dev = jnp.asarray(affine_b, jnp.float32)
        est_t = est_scores_of(
            arrays, qpad, true_ids, signs, a_dev, b_dev, float(kappa)
        )
        counts = np.asarray(
            count_leq(arrays, qpad, est_t, signs, a_dev, b_dev, float(kappa))
        )
        per_cohort.append(ranks_from_counts(counts, anchors))
    return budget_from_cohorts(per_cohort, anchors)


def ranks_from_counts(counts: np.ndarray, anchors) -> np.ndarray:
    """Per-anchor top_c from the (Q, k_max) estimate-rank counts: the
    RANK_QUANTILE tail of per-neighbor ranks times RANK_SAFETY."""
    return np.asarray(
        [
            np.ceil(np.quantile(counts[:, :a], RANK_QUANTILE) * RANK_SAFETY)
            for a in anchors
        ],
        np.int64,
    )


def budget_from_cohorts(per_cohort: list, anchors) -> CandidateBudget:
    """Per-anchor max over cohorts, floored at the anchor itself and made
    monotone in k."""
    ranks = (
        np.maximum.reduce(per_cohort) if len(per_cohort) > 1
        else per_cohort[0]
    )
    ranks = np.maximum.accumulate(np.maximum(ranks, np.asarray(anchors)))
    return CandidateBudget(
        anchors=np.asarray(anchors, np.int64), ranks=ranks
    )
