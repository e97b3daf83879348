"""The EVT-CRC calibration pipeline: data-derived search parameters.

Re-implementation of Index::calibrate_estimator
(/root/reference/include/cphnsw/api/hnsw_index.hpp:718-1139) — the component
that makes the index "calibration-parameterless": every search-time constant
(affine correction, ip_qo floor, gamma bounds/adaptation, the EVT slack
ladder, the termination gamma) is derived from the built index itself.

Device/host split: estimator evaluations for all calibration samples run as ONE
batched device program (queries x parent edges — the reference loops
per-query per-batch on the CPU, :786-871); the scalar statistics (Huber fit,
MAD fences, Tukey fences, Grimshaw GPD) run host-side on the resulting
sample arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu.calibration import evt, huber
from cphnsw_tpu.ops import estimate, pack, quantize

EPS_SMALL = 1e-12
EPS_MEDIUM = 1e-10
BASEL_K = 6.0 / (math.pi * math.pi)      # constants.hpp:77
MIN_CALIBRATE_NODES = 50                  # constants.hpp:81
MAX_SLACK_ARRAY = 32                      # constants.hpp:29
SEARCH_DELTA = 1e-4                       # hnsw_index.hpp:1117


@dataclass
class IndexProfile:
    """Metadata-derived parameters (core/adaptive_defaults.hpp:27-58)."""

    n: int = 0
    padded_dim: int = 0
    r: int = 0
    bits: int = 0
    evt_min_tail: int = 64
    min_calib_samples: int = 200
    slack_levels: int = 4

    @classmethod
    def derive(cls, n: int, padded_dim: int, r: int, bits: int):
        evt_min_tail = max(64, int(math.isqrt(n)))
        min_calib_samples = int(np.clip(10.0 * math.sqrt(n), 200, n))
        log_n = math.log2(max(n, 64))
        slack_levels = int(
            np.clip(math.ceil(math.log2(max(10.0 * log_n, 4.0))), 4,
                    MAX_SLACK_ARRAY)
        )
        return cls(
            n=n, padded_dim=padded_dim, r=r, bits=bits,
            evt_min_tail=evt_min_tail,
            min_calib_samples=min_calib_samples,
            slack_levels=slack_levels,
        )

    def to_dict(self):
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@dataclass
class CalibrationSnapshot:
    """All fields of the reference CalibrationSnapshot
    (api/hnsw_index.hpp:32-58)."""

    affine_a: float = 1.0
    affine_b: float = 0.0
    ip_qo_floor: float = 0.0
    median_nn_dist_sq: float = 0.0
    min_slack_sq: float = 0.0
    median_nop: float = 0.0
    evt: evt.EVTState = field(default_factory=evt.EVTState)
    gamma_min: float = 1.0
    gamma_max: float = 2.0
    gamma_beta: float = 1.0
    gamma_warmup: int = 16
    slack_levels: int = 4
    search_ip_slack_levels: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SLACK_ARRAY)
    )
    search_num_slack_levels: int = 4
    search_gamma: float = 1.0

    def to_dict(self):
        d = self.__dict__.copy()
        d["evt"] = self.evt.to_dict()
        d["search_ip_slack_levels"] = [
            float(x) for x in self.search_ip_slack_levels
        ]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["evt"] = evt.EVTState.from_dict(d["evt"])
        d["search_ip_slack_levels"] = np.asarray(d["search_ip_slack_levels"])
        return cls(**d)


def _collect_samples(
    raw, norm_sq, neighbors, signs, bits, query_vecs, parent0,
):
    """Device pass: greedy one-hop parent selection + per-edge estimator
    samples for a batch of calibration queries (hnsw_index.hpp:786-871).

    Returns host arrays: nn_dist_sq (Qc,), and per-edge (Qc, R):
    ip_corrected, ip_qo_denom(raw ip_qo), nop, dist_qp_sq, true_ip,
    true_dist, valid mask."""
    p = signs.shape[-1]
    k_scale = float((1 << bits) - 1)

    # NOTE: raw/norm_sq/neighbors must be ARGUMENTS, not closures — the
    # remote-compile backend serializes closure constants into the compile
    # request (GBs at 1M nodes -> broken pipe).
    @jax.jit
    def run(raw, norm_sq, neighbors, signs, query_vecs, parent0):
        qnorm = jnp.sum(query_vecs * query_vecs, axis=-1)
        # one-hop greedy: parent0 vs its neighbors
        nbr0 = neighbors.ids[parent0]                       # (Qc, R)
        nbr0_safe = jnp.maximum(nbr0, 0)
        d_par = estimate.exact_l2_sq(
            query_vecs, qnorm, raw[parent0][:, None, :],
            norm_sq[parent0][:, None],
        )[:, 0]
        d_nbr = estimate.exact_l2_sq(
            query_vecs, qnorm, raw[nbr0_safe], norm_sq[nbr0_safe]
        )
        d_nbr = jnp.where(nbr0 >= 0, d_nbr, jnp.inf)
        best_j = jnp.argmin(d_nbr, axis=1)
        best_d = jnp.take_along_axis(d_nbr, best_j[:, None], 1)[:, 0]
        take_nbr = best_d < d_par
        parent = jnp.where(
            take_nbr,
            jnp.take_along_axis(nbr0, best_j[:, None], 1)[:, 0],
            parent0,
        )
        nn_dist_sq = jnp.minimum(best_d, d_par)

        # estimator samples over the chosen parent's edges
        qc = quantize.encode_queries(query_vecs, signs)
        ids = neighbors.ids[parent]
        valid = ids >= 0
        ids_safe = jnp.maximum(ids, 0)
        u = pack.unpack_planes(neighbors.planes[parent], p)
        fs = jnp.einsum("qrp,qp->qr", u, qc.q_u,
                        preferred_element_type=jnp.int32)
        aux = neighbors.aux[parent]                  # (Qc, R, 4)
        ip_approx = estimate.ip_from_fastscan(
            fs, aux[..., 3],
            qc.coeff_a[:, None], qc.coeff_b[:, None], qc.coeff_c[:, None],
            k_scale,
        )
        ip_corrected = ip_approx - aux[..., 2]
        ip_qo = aux[..., 1]
        nop = jnp.maximum(aux[..., 0], EPS_SMALL)
        dist_qp_sq = estimate.exact_l2_sq(
            query_vecs, qnorm, raw[parent][:, None, :],
            norm_sq[parent][:, None],
        )[:, 0]

        pvec = raw[parent]                                   # (Qc, P)
        nvec = raw[ids_safe]                                 # (Qc, R, P)
        true_ip = jnp.einsum(
            "qp,qrp->qr", query_vecs - pvec, nvec - pvec[:, None, :],
            precision=jax.lax.Precision.HIGHEST,
        ) / nop
        true_dist = estimate.exact_l2_sq(
            query_vecs, qnorm, nvec, norm_sq[ids_safe]
        )
        return (nn_dist_sq, ip_corrected, ip_qo, nop, dist_qp_sq,
                true_ip, true_dist, valid)

    out = run(raw, norm_sq, neighbors, signs, query_vecs, parent0)
    return [np.asarray(o) for o in out]


def calibrate(
    raw,
    norm_sq,
    neighbors,
    signs,
    bits: int,
    profile: IndexProfile,
    seed: int = 42 + 99999,
    verbose: bool = False,
) -> CalibrationSnapshot:
    """Full calibration (hnsw_index.hpp:718-1139)."""
    import time as _time

    _t0 = _time.time()

    def _tick(label):
        nonlocal _t0
        if verbose:
            print(f"calibrate/{label}: {_time.time() - _t0:.1f}s", flush=True)
        _t0 = _time.time()

    n, p = raw.shape
    if n < MIN_CALIBRATE_NODES:
        raise RuntimeError("Calibration requires at least 50 nodes.")

    num_samples = min(profile.min_calib_samples, n)
    rng = np.random.default_rng(seed)
    sample_ids = rng.permutation(n)

    n_db = min(num_samples, n)
    n_synth = min(num_samples // 2, n)

    # per-dim variance for synthetic query jitter (:735-754)
    var_sample = max(min(n, num_samples // 4), 2)
    vs = np.asarray(raw[jnp.asarray(sample_ids[:var_sample])])
    dim_var = np.maximum(vs.var(axis=0), EPS_SMALL)

    # queries: database vectors + jittered synthetics (:873-890)
    db_ids = sample_ids[:n_db]
    db_q = np.asarray(raw[jnp.asarray(db_ids)])
    synth_base = np.asarray(
        raw[jnp.asarray(sample_ids[np.arange(n_synth) % n])]
    )
    synth_q = synth_base + rng.standard_normal(
        synth_base.shape
    ).astype(np.float32) * np.sqrt(dim_var).astype(np.float32)
    queries = np.concatenate([db_q, synth_q], axis=0).astype(np.float32)
    # Parent cursor offset by one: the reference pairs db query i with
    # parent sample_ids[i] — the query's own node (hnsw_index.hpp:786-787,
    # :873-879) — so nn_dist collapses to 0, median_nn_dist_sq ~ 0 and the
    # gamma fences blow up (termination effectively disabled).  Offsetting
    # the cursor keeps the nn-distance samples meaningful.
    parent0 = sample_ids[(np.arange(len(queries)) + 1) % n].astype(np.int32)

    _tick("prep")
    (nn_dist_sq, ip_corrected, ip_qo, nop, dist_qp_sq, true_ip,
     true_dist, valid) = _collect_samples(
        raw, norm_sq, neighbors, signs, bits,
        jnp.asarray(queries), jnp.asarray(parent0),
    )
    _tick("device_samples")

    v = valid.ravel()
    ip_corrected_f = ip_corrected.ravel()[v]
    ip_qo_f = ip_qo.ravel()[v]
    nop_f = nop.ravel()[v]
    true_ip_f = true_ip.ravel()[v]
    true_dist_f = true_dist.ravel()[v]
    dqp_f = np.repeat(dist_qp_sq, valid.shape[1])[v]

    if ip_qo_f.size == 0:
        raise RuntimeError("Calibration failed: no ip_qo samples.")

    snap = CalibrationSnapshot()

    # ip_qo_floor: MAD lower fence (:896-910)
    snap.ip_qo_floor = float(
        max(huber.mad_lower_fence(ip_qo_f, 3.0, EPS_MEDIUM), EPS_MEDIUM)
    )

    ip_qo_denom = np.maximum(np.abs(ip_qo_f), EPS_MEDIUM)
    floored_qo = np.maximum(ip_qo_denom, snap.ip_qo_floor)
    floored_estimates = ip_corrected_f / floored_qo

    if floored_estimates.size < 20:
        raise RuntimeError(
            "Calibration failed: too few estimator/target pairs."
        )

    a, b, _ = huber.fit_affine_huber(floored_estimates, true_ip_f)
    snap.affine_a, snap.affine_b = float(a), float(b)

    if nn_dist_sq.size == 0:
        raise RuntimeError(
            "Calibration failed: no nearest-neighbor distance samples."
        )
    snap.median_nn_dist_sq = float(np.median(nn_dist_sq))
    snap.min_slack_sq = max(EPS_SMALL, snap.median_nn_dist_sq * 1e-4)

    # distance residuals with the fitted affine (:1029-1043)
    ip_est = np.where(
        floored_qo > EPS_MEDIUM, ip_corrected_f / floored_qo, 0.0
    )
    ip_est = snap.affine_a * ip_est + snap.affine_b
    est_dist = np.maximum(nop_f * nop_f + dqp_f - 2.0 * nop_f * ip_est, 0.0)
    dist_residuals = np.abs(est_dist - true_dist_f)

    n_resid = dist_residuals.size
    evt_thresh_min = max(1.0 - 1.0 / math.sqrt(max(n_resid, 4)), 0.5)
    evt_thresh_max = 1.0 - profile.evt_min_tail / max(n_resid, 1)
    _tick("huber+floor")
    snap.evt = evt.fit_gpd_stable(
        dist_residuals, profile.evt_min_tail, evt_thresh_min, evt_thresh_max
    )
    _tick("evt_fit")

    if nop_f.size == 0:
        raise RuntimeError("Calibration failed: no nop samples.")
    snap.median_nop = float(np.median(nop_f))
    if snap.median_nop <= 0.0:
        raise RuntimeError("Calibration failed: degenerate nop samples.")

    if not snap.evt.fitted:
        # Tiny datasets cannot sustain a GPD tail fit (tail < evt_min_tail;
        # the reference throws here, hnsw_index.hpp:1064-1066).  Degrade
        # gracefully to pure empirical quantile checkpoints instead — the
        # same machinery the KS-rejection fallback uses.
        srt = np.sort(dist_residuals)
        st = evt.EVTState()
        st.u = float(srt[n_resid // 2])
        st.p_u = 0.5
        st.n_tail = n_resid - n_resid // 2
        st.fitted = True
        st.use_empirical = True
        cps = np.zeros(evt.N_CHECKPOINTS)
        for j, alpha in enumerate(evt.CHECKPOINT_ALPHAS):
            idx = min(int((1.0 - alpha) * n_resid), n_resid - 1)
            cps[j] = srt[idx]
        st.empirical_checkpoints = cps
        snap.evt = st

    # gamma bounds via Tukey fences on normalized residuals (:1069-1091)
    ref = math.sqrt(max(snap.median_nn_dist_sq, snap.min_slack_sq))
    norm_resid = np.sort(dist_residuals) / ref
    nr_q1 = norm_resid[n_resid // 4]
    nr_median = norm_resid[n_resid // 2]
    nr_q3 = norm_resid[3 * n_resid // 4]
    nr_iqr = nr_q3 - nr_q1

    gamma_min_floor = 1.0 + 1.0 / math.sqrt(p)
    gamma_min_data = 1.0 + norm_resid[max(1, n_resid // 100)]
    snap.gamma_min = max(gamma_min_data, gamma_min_floor)

    gamma_max_fence = 1.0 + nr_q3 + 1.5 * nr_iqr
    min_offset = max(nr_iqr, nr_median)
    snap.gamma_max = max(gamma_max_fence, snap.gamma_min + min_offset)

    # gamma beta = 1/CV (:1094-1106)
    rmean = float(dist_residuals.mean())
    rstd = float(dist_residuals.std())
    resid_cv = rstd / max(rmean, EPS_SMALL)
    cv_floor = 1.0 / math.sqrt(2.0 * (max(n_resid, 2) - 1))
    snap.gamma_beta = 1.0 / max(resid_cv, cv_floor)
    snap.gamma_warmup = max(4, int(math.ceil(math.sqrt(snap.evt.n_tail))))

    # EVT slack ladder + termination gamma (:1114-1138)
    snap.slack_levels = profile.slack_levels
    delta_prune = 0.5 * SEARCH_DELTA
    delta_term = 0.5 * SEARCH_DELTA
    evt_l = int(np.clip(profile.slack_levels, 1, MAX_SLACK_ARRAY))
    snap.search_num_slack_levels = evt_l
    levels = np.zeros(MAX_SLACK_ARRAY)
    for i in range(1, evt_l + 1):
        alpha_i = delta_prune * BASEL_K / (i * i)
        dist_slack = evt.evt_quantile(alpha_i, snap.evt)
        levels[i - 1] = dist_slack / (2.0 * snap.median_nop)
    snap.search_ip_slack_levels = levels

    dist_slack_term = evt.evt_quantile(delta_term, snap.evt)
    snap.search_gamma = float(
        np.clip(1.0 + dist_slack_term / ref, snap.gamma_min, snap.gamma_max)
    )
    return snap


def to_search_params(snap: CalibrationSnapshot):
    """Device-resident SearchParams from a host snapshot."""
    from cphnsw_tpu.search.beam import SearchParams

    L = max(snap.search_num_slack_levels, 1)
    return SearchParams(
        affine_a=jnp.float32(snap.affine_a),
        affine_b=jnp.float32(snap.affine_b),
        ip_qo_floor=jnp.float32(snap.ip_qo_floor),
        slack_levels=jnp.asarray(
            snap.search_ip_slack_levels[:L], dtype=jnp.float32
        ),
        gamma=jnp.float32(snap.search_gamma),
        gamma_max=jnp.float32(snap.gamma_max),
        gamma_beta=jnp.float32(snap.gamma_beta),
        gamma_warmup=jnp.int32(snap.gamma_warmup),
    )
