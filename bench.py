"""Headline benchmark: QPS at recall@10 on synthetic SIFT-like data.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the device as JAX reports it and the card's name and power limit
as nvidia-smi reports them.  Runs on a GPU only: with no GPU it exits
non-zero before measuring anything.

Engine: CPIndex auto-selection (the full-database scan).  The recorded
operating point is the 8192-query serving batch, where fixed per-call
costs (query upload, dispatch, result download) amortize across the
batch; the 1024-query batch is reported alongside.

The reference publishes no numbers (BASELINE.md); vs_baseline compares
against a self-measured AVX2 reference run recorded in baseline_cpu.json
(produced by native/measure_reference.sh on a CPU host) when that file
exists, else 1.0.  The AVX2 run is the same full-query-set batch
workload (its OpenMP loop also amortizes per-batch costs).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def timed_qps(index, queries, k, n_runs=5):
    index.search_batch(queries, k=k)  # warmup/compile
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        ids, _ = index.search_batch(queries, k=k)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return len(queries) / med, ids


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    from cphnsw_tpu.api.index import CPIndex
    from cphnsw_tpu.utils.datasets import make_synthetic
    from cphnsw_tpu.utils.eval import recall_at_k

    n, dim, k = 100_000, 128, 10
    ds = make_synthetic(f"synthetic-{n // 1000}k-{dim}d", n_queries=8192)
    base, queries, gt = ds["base"], ds["queries"], ds["groundtruth"]

    t0 = time.perf_counter()
    index = CPIndex(dim=dim, bits=1)
    index.build(base)
    index.finalize()
    build_s = time.perf_counter() - t0

    qps, ids = timed_qps(index, queries, k)
    r10 = recall_at_k(np.asarray(ids), gt.astype(np.int64), k)
    qps_small, ids_small = timed_qps(index, queries[:1024], k)
    r10_small = recall_at_k(
        np.asarray(ids_small), gt[:1024].astype(np.int64), k
    )

    baseline_file = Path(__file__).parent / "baseline_cpu.json"
    vs_baseline = 1.0
    ref_note = "no baseline_cpu.json"
    if baseline_file.exists():
        ref = json.loads(baseline_file.read_text())
        ref_qps = ref.get("qps_sift100k_1bit")
        ref_recall = ref.get("recall_at_10", 0.0)
        if ref_qps:
            vs_baseline = qps / ref_qps
            ref_note = (
                f"ref AVX2 1-core full-batch: {ref_qps:.0f} qps @ recall "
                f"{ref_recall:.3f} (fails the 0.95 recall bar; "
                f"raw-qps ratio shown)"
            )

    print(
        json.dumps(
            {
                "metric": "qps_at_recall10_synth100k_128d_1bit",
                # the explicit batch_size keeps comparisons across
                # operating points honest
                "batch_size": 8192,
                "recall_at_10": round(float(r10), 4),
                "value": round(qps, 1),
                "unit": f"qps@8192q serving batch (recall@10={r10:.4f}; "
                f"qps@1024q={qps_small:.0f} @ recall {r10_small:.4f}; "
                f"build={build_s:.1f}s, engine={index.engine}; "
                f"{ref_note})",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "card": card,
                "vs_baseline": round(vs_baseline, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
