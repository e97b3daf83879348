"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the package's compile-cache placement."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cphnsw_tpu
from cphnsw_tpu.utils import datasets

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _all_ok(lines):
    assert lines and all(ln["ok"] for ln in lines), lines
    return lines


def test_phase_main_tiny(smoke):
    lines = _all_ok(smoke.phase_scan(
        "main", 3000, 32, 1, [(64, 10), (64, 100), (32, 10)], 0.9, seed=0
    ))
    assert [(ln["q"], ln["k"]) for ln in lines] == [(64, 10), (64, 100),
                                                    (32, 10)]
    for ln in lines:
        assert ln["engine"] == "scan" and ln["all_valid"]
        assert ln["max_scaled_err"] <= smoke.DIST_RTOL


def test_phase_nbit_ip_tiny(smoke):
    (line,) = _all_ok(smoke.phase_scan(
        "nbit_wide_ip", 2000, 48, 4, [(64, 10)], 0.85, seed=1, metric="ip"
    ))
    assert line["metric"] == "ip" and line["bits"] == 4


def test_phase_scale_reports_plan(smoke):
    (line,) = _all_ok(smoke.phase_scan(
        "scale", 4000, 24, 1, [(64, 10)], 0.9, seed=2, plan=True
    ))
    plan = line["plan"]
    assert plan["kernel"] is False  # CPU: the XLA chunked path
    assert plan["mode"] in ("estimate-select", "two-stage-gather")
    assert plan["top_c"] >= 10 and plan["sub_batch"] >= 256


def test_phase_save_load_tiny(smoke):
    (line,) = _all_ok(smoke.phase_save_load(2000, 32, 64, seed=3))
    assert line["identical"]


def test_phase_graph_tiny(smoke):
    (line,) = _all_ok(smoke.phase_graph(2000, 32, 64, 0.9, seed=4))
    assert line["engine"] == "graph"


def test_phase_four_on_virtual_devices(smoke):
    assert len(jax.devices()) >= 4
    (line,) = _all_ok(smoke.phase_four(4000, 32, 64, 0.9, seed=5))
    assert line["cards"] == 4 and line["mesh"] == {"data": 1, "model": 4}
    assert line["per_card_bytes_ok"] and line["id_agreement"] >= 0.99


def test_main_refuses_without_gpu(smoke, capsys):
    assert jax.default_backend() != "gpu"
    assert smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err and "cpu" in err


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_synthetic_rows_slice_equals_whole_store():
    base, queries = datasets._device_synthetic(1000, 8, 5, 4, seed=0)
    part = datasets.synthetic_rows(jnp.arange(300, 700), 8, 4, 0)
    np.testing.assert_array_equal(np.asarray(base[300:700]),
                                  np.asarray(part))
    assert queries.shape == (5, 8)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
            jax.config.update("jax_compilation_cache_dir", None)
            assert cphnsw_tpu._configure_compile_cache(env) == str(tmp_path)
            # JAX reads the variable itself: the package sets nothing
            assert jax.config.jax_compilation_cache_dir is None
        else:
            got = cphnsw_tpu._configure_compile_cache({})
            assert got == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_smoke_last_line_contract(smoke, monkeypatch, capsys):
    """With every phase stubbed to pass, main prints the card line and
    ends on exactly the contract line."""

    class FakeDev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(smoke.jax, "devices", lambda: [FakeDev()])
    monkeypatch.setattr(smoke, "one_card_phases",
                        lambda seed: [{"phase": "x", "ok": True}])
    monkeypatch.setattr(smoke, "card_line", lambda: "H100, 700.00 W")
    assert smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "H100, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
    }}
