"""Test harness config.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`), on a virtual 8-device CPU
mesh so sharding logic is exercised without several cards (SURVEY.md §4
item 4).  XLA_FLAGS must be set before the first backend init, hence here.

The GPU lane (`-m gpu`, tests/test_gpu_hw.py) runs on a machine with a card
and JAX_PLATFORMS unset; its tests skip themselves, inside a fixture, when
the backend is not the GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
