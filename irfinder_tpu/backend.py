"""The one module that knows which backend the program runs on.

* `on_gpu()` / `device_stats_enabled()`: the engines compute per-intron
  finalize statistics on the device when the backend is the GPU; the CPU
  keeps the host path (the reference the tests compare against) unless
  IRTPU_DEVICE_STATS=1 asks for the device program there too.
* `init_compile_cache()`: JAX's persistent compilation cache.  When
  JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing here
  overrides it; otherwise the cache lives at one fixed path inside the
  checkout (`.jax_cache/`, git-ignored), so a later process finds it again.
* `describe()` / `gpu_name_power()`: the device as JAX reports it and the
  card's name and power limit as nvidia-smi reports them — every timing is
  printed beside these.

Nothing here falls back from one backend to another: JAX picks the backend
(the GPU on a machine with a card; tests select the CPU explicitly with
JAX_PLATFORMS=cpu).
"""

from __future__ import annotations

import os
import subprocess

import jax

#: root of the checkout (the directory holding the irfinder_tpu package)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: compile-cache directory used when JAX_COMPILATION_CACHE_DIR is not set
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def device_stats_enabled() -> bool:
    """Device-side finalize statistics (ops/finalize_stats.py): on by
    default on the GPU; IRTPU_DEVICE_STATS=1 runs the same XLA program on
    the CPU (the parity tests use this)."""
    return on_gpu() or os.environ.get("IRTPU_DEVICE_STATS") == "1"


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def init_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    return that path.  Call before the first compilation: JAX fixes the
    cache when it first compiles."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def describe() -> dict:
    """Device identity as JAX reports it (the keys every result line of
    chip_smoke.py and the benches carries)."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_power() -> "str | None":
    """`name, power.limit` of each card (one line per card) as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; None where nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None
