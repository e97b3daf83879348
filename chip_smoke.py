#!/usr/bin/env python3
"""Drive the scan index end to end on a GPU and check what it returns.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # the sharded 10M phase on four cards

Every store is generated on the device from --seed.  Each phase builds
its index through the public entry points (CPIndex, ShardedScanIndex),
searches it, and checks recall@10 against exact ground truth
(utils/datasets._device_groundtruth, f32 at HIGHEST precision) and the
returned distances against exact distances from the f32 queries.  It
prints one JSON line per phase.  The last line of a passing run is
{"ok": true, "device": {...}}; any failed check or error exits non-zero,
and so does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from cphnsw_tpu import CPIndex
from cphnsw_tpu.parallel import sharded
from cphnsw_tpu.utils import datasets

N_CLUSTERS = 256
# Distance bar: |d - exact| over the magnitudes the f32 rerank combines
# (|q|^2 + |x|^2 for l2, |q|^2 + the ip norm bound for ip).  The rerank
# is the reference's |q|^2 + |x|^2 - 2<q,x> in f32, whose rounding is a
# few f32 ulps of those magnitudes; a TF32 or f16 step anywhere on the
# path shows up at 1e-4 to 1e-3 of them.
DIST_RTOL = 1e-5


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip()


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def check_results(base, queries, ids, dists, gt, metric: str,
                  ip_bound: float | None = None) -> dict:
    """recall@10 against `gt` and the distance errors of every returned
    id, against float64 distances from the f32 query and stored row."""
    recall = float(
        (ids[:, :10, None] == gt[:, None, :10]).any(-1).mean()
    )
    valid = ids >= 0
    rows = np.asarray(
        base[jnp.asarray(np.maximum(ids, 0).astype(np.int32))],
        np.float64,
    )                                                    # (Q, k, dim)
    q = queries.astype(np.float64)[:, None, :]
    qn = (q * q).sum(-1)
    if metric == "ip":
        exact = (q * rows).sum(-1)
        scale = np.broadcast_to(qn + ip_bound, exact.shape)
    else:
        exact = ((q - rows) ** 2).sum(-1)
        scale = qn + (rows * rows).sum(-1)
    err = np.abs(dists.astype(np.float64) - exact)[valid]
    return dict(
        recall_at_10=round(recall, 6),
        max_rel_err=float(
            (err / np.maximum(np.abs(exact[valid]), 1e-30)).max()
        ),
        max_scaled_err=float((err / scale[valid]).max()),
        all_valid=bool(valid.all()),
    )


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_scan(name: str, n: int, dim: int, bits: int, runs, bar: float,
               seed: int, metric: str = "l2", plan: bool = False
               ) -> list[dict]:
    """Build CPIndex(dim, bits, metric) on an n-row store and search it
    once per (Q, k) in `runs`; one checked JSON line per run."""
    q_max = max(q for q, _ in runs)
    base, queries = datasets._device_synthetic(n, dim, q_max, N_CLUSTERS,
                                               seed)
    gt = datasets._device_groundtruth(base, queries, 10, metric=metric)
    index = CPIndex(dim, bits=bits, metric=metric)
    _, build_s = _timed(lambda: (index.build(base), index.finalize()))
    ip_bound = None
    if metric == "ip":
        ip_bound = float(jnp.max(jnp.sum(base * base, axis=1)))
    lines = []
    for q, k in runs:
        qs = queries[:q]
        _, first_s = _timed(lambda: index.search_batch(qs, k))
        (ids, dists), search_s = _timed(lambda: index.search_batch(qs, k))
        chk = check_results(base, qs, ids, dists, gt[:q], metric, ip_bound)
        line = dict(
            phase=name, n=n, dim=dim, metric=metric, bits=bits, k=k, q=q,
            engine=index.engine, **chk, recall_bar=bar,
            dist_rtol=DIST_RTOL, build_s=round(build_s, 3),
            first_search_s=round(first_s, 4), search_s=round(search_s, 4),
            peak_bytes_in_use=peak_bytes(),
        )
        if plan:
            line["plan"] = index._index.search_plan(k)
        line["ok"] = bool(
            chk["recall_at_10"] >= bar and chk["all_valid"]
            and chk["max_scaled_err"] <= DIST_RTOL
        )
        lines.append(emit(line))
    return lines


def phase_save_load(n: int, dim: int, q: int, seed: int) -> list[dict]:
    """Save, reload into a fresh CPIndex, search again: identical."""
    base, queries = datasets._device_synthetic(n, dim, q, N_CLUSTERS, seed)
    index = CPIndex(dim, bits=1)
    index.build(base)
    index.finalize()
    ids0, d0 = index.search_batch(queries, 10)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "index.npz")
        (_, save_s) = _timed(lambda: index.save(path))
        again = CPIndex(dim, bits=1)
        (_, load_s) = _timed(lambda: again.load(path))
        ids1, d1 = again.search_batch(queries, 10)
    same = bool(np.array_equal(ids0, ids1) and np.array_equal(d0, d1))
    return [emit(dict(
        phase="save_load", n=n, dim=dim, q=q, k=10, identical=same,
        save_s=round(save_s, 3), load_s=round(load_s, 3),
        peak_bytes_in_use=peak_bytes(), ok=same,
    ))]


def phase_graph(n: int, dim: int, q: int, bar: float, seed: int,
                n_clusters: int = 24) -> list[dict]:
    """The graph engine (off the main path) builds and searches.  Its
    store has few large clusters (24, as in tests/test_index.py, whose
    recall bar it shares); on the 256-cluster store of the scan phases
    its recall sits near the bar (PERF.md)."""
    base, queries = datasets._device_synthetic(n, dim, q, n_clusters, seed)
    gt = datasets._device_groundtruth(base, queries, 10)
    index = CPIndex(dim, engine="graph")
    _, build_s = _timed(lambda: (index.build(base), index.finalize()))
    _, first_s = _timed(lambda: index.search_batch(queries, 10))
    (ids, dists), search_s = _timed(lambda: index.search_batch(queries, 10))
    chk = check_results(base, queries, ids, dists, gt, "l2")
    return [emit(dict(
        phase="graph", n=n, dim=dim, metric="l2", bits=1, k=10, q=q,
        clusters=n_clusters, engine=index.engine, **chk, recall_bar=bar,
        dist_rtol=DIST_RTOL,
        build_s=round(build_s, 3), first_search_s=round(first_s, 4),
        search_s=round(search_s, 4), peak_bytes_in_use=peak_bytes(),
        ok=bool(chk["recall_at_10"] >= bar and chk["all_valid"]
                and chk["max_scaled_err"] <= DIST_RTOL),
    ))]


def phase_four(n: int, dim: int, q: int, bar: float, seed: int,
               n_cards: int = 4, agree_bar: float = 0.99) -> list[dict]:
    """ShardedScanIndex over a 1 x n_cards mesh (the "model" axis over
    every card), built through the row provider so no card stages the
    whole store; compared in this process with the single-card
    ScanIndex on card 0 and with exact ground truth."""
    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} devices, found {len(devs)}")
    mesh = sharded.make_mesh(1, n_cards, devs)

    def provider(shard, start, rows):
        return datasets.synthetic_rows(
            jnp.arange(start, start + rows), dim, N_CLUSTERS, seed
        )

    provider.n_rows = n
    sidx = sharded.ShardedScanIndex(dim, 1)
    _, build_s = _timed(lambda: sidx.build(provider, mesh))
    per_card_ok = True
    for field in sidx._store._fields:
        arr = getattr(sidx._store, field)
        for sh in arr.addressable_shards:
            per_card_ok &= sh.data.nbytes <= arr.nbytes // n_cards + 1024
    queries = datasets.synthetic_queries(n, dim, q, N_CLUSTERS, seed)
    _, first_s = _timed(lambda: sidx.search_batch(queries, 10))
    (ids_s, d_s), search_s = _timed(lambda: sidx.search_batch(queries, 10))

    with jax.default_device(devs[0]):
        base = datasets.synthetic_rows(jnp.arange(n), dim, N_CLUSTERS, seed)
        gt = datasets._device_groundtruth(base, queries, 10)
        single = CPIndex(dim, bits=1)
        single.build(base)
        single.finalize()
        ids_1, _ = single.search_batch(queries, 10)
    chk = check_results(base, queries, ids_s, d_s, gt, "l2")
    recall_1 = float((ids_1[:, :, None] == gt[:, None, :]).any(-1).mean())
    agreement = float((ids_s[:, :, None] == ids_1[:, None, :]).any(-1).mean())
    return [emit(dict(
        phase="four", n=n, dim=dim, metric="l2", bits=1, k=10, q=q,
        cards=n_cards, mesh=dict(mesh.shape), **chk,
        single_card_recall_at_10=round(recall_1, 6),
        id_agreement=round(agreement, 6), agreement_bar=agree_bar,
        recall_bar=bar, per_card_bytes_ok=bool(per_card_ok),
        dist_rtol=DIST_RTOL, build_s=round(build_s, 3),
        first_search_s=round(first_s, 4), search_s=round(search_s, 4),
        ok=bool(
            agreement >= agree_bar and chk["recall_at_10"] >= bar
            and per_card_ok and chk["all_valid"]
            and chk["max_scaled_err"] <= DIST_RTOL
        ),
    ))]


def one_card_phases(seed: int) -> list[dict]:
    lines = phase_scan("main", 1_000_000, 128, 1,
                       [(8192, 10), (8192, 100), (1024, 10)], 0.98, seed)
    lines += phase_scan("nbit_wide_ip", 100_000, 1536, 4, [(1024, 10)],
                        0.95, seed, metric="ip")
    lines += phase_scan("scale", 10_000_000, 96, 1, [(8192, 10)], 0.98,
                        seed, plan=True)
    lines += phase_save_load(100_000, 128, 1024, seed)
    lines += phase_graph(20_000, 64, 256, 0.9, seed)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phase on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    count = 4 if args.four else 1
    emit(dict(
        platform=dev.platform, device_kind=dev.device_kind,
        device_count=len(jax.devices()), jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=jax.config.jax_compilation_cache_dir,
        card=card_line(),
    ))
    if args.four:
        lines = phase_four(10_000_000, 96, 1024, 0.98, args.seed, count)
    else:
        lines = one_card_phases(args.seed)
    failed = [ln.get("phase") for ln in lines if not ln["ok"]]
    print(card_line(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
