"""cphnsw_tpu — calibration-parameterless ANN search in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the CP-HNSW
reference library (indrajeetadityaroy9/rabitq-ann-search):

* Parameter-free search — all search hyperparameters derived at build time
  by an EVT-CRC statistical calibration pipeline.
* DABS (Distance-Adaptive Beam Search) with online gamma adaptation.
* N-bit RaBitQ + CAQ quantization, scanned with int8 matrix products (the
  accelerator replacement for AVX2 VPSHUFB FastScan), with exact-L2
  reranking.

Public API (mirrors reference `cphnsw.CPIndex`, src/bindings.cpp:115-240):
    CPIndex(dim, bits) . build / finalize / search / search_batch /
    save / load / size / dim / is_finalized
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only when it is unset does the package pick a fixed directory
# beside the checkout (a fixed path, so later processes hit it).
DEFAULT_COMPILE_CACHE = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")
)


def _configure_compile_cache(environ=_os.environ) -> str:
    """Point JAX's persistent cache at DEFAULT_COMPILE_CACHE unless
    JAX_COMPILATION_CACHE_DIR is set; returns the directory in use."""
    if "JAX_COMPILATION_CACHE_DIR" in environ:
        return environ["JAX_COMPILATION_CACHE_DIR"]
    _jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_COMPILE_CACHE


_configure_compile_cache()

from cphnsw_tpu.api.index import CPIndex, Index

__all__ = [
    "CPIndex", "Index", "ScanIndex", "ShardedIndex", "ShardedScanIndex"
]


def __getattr__(name):  # lazy: parallel/ pulls in shard_map machinery
    if name in ("ShardedIndex", "ShardedScanIndex"):
        from cphnsw_tpu.parallel import sharded

        return getattr(sharded, name)
    if name == "ScanIndex":
        from cphnsw_tpu.api.scan_index import ScanIndex

        return ScanIndex
    raise AttributeError(name)
__version__ = "0.1.0"
