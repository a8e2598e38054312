"""irfinder_tpu — an accelerator-native intron-retention quantification engine.

A from-scratch framework with the capabilities of IRFinder (formerly
williamritchie/IRFinder; the mounted snapshot /root/reference/README.md:1-7 is
a repository-moved tombstone — see SURVEY.md for the full reconstruction).
Architecture: batched columnar counting on the GPU via JAX/XLA, a native
C++ host BAM decoder, and mesh-sharded integer counters merged with XLA
collectives.
"""

__version__ = "0.5.0"


def __getattr__(name):
    # lazy top-level API: importing irfinder_tpu stays light (no jax init);
    # the commonly-used entry points resolve on first touch
    _api = {
        "run_bam": ("irfinder_tpu.engine", "run_bam"),
        "run_multi_bam": ("irfinder_tpu.engine", "run_multi_bam"),
        "Engine": ("irfinder_tpu.engine", "Engine"),
        "RunConfig": ("irfinder_tpu.config", "RunConfig"),
        "compile_reference": ("irfinder_tpu.refio.compile", "compile_reference"),
        "CompiledRef": ("irfinder_tpu.refio.compile", "CompiledRef"),
        "run_bam_mesh": ("irfinder_tpu.engine_mesh", "run_bam_mesh"),
        "MeshSpec": ("irfinder_tpu.engine_mesh", "MeshSpec"),
        "run_differential": ("irfinder_tpu.diff", "run_differential"),
    }
    if name in _api:
        import importlib

        mod, attr = _api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'irfinder_tpu' has no attribute {name!r}")
