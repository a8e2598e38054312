"""ctypes bindings to the native C++ components under native/ (pybind11 is
not in this image; the C ABI + ctypes is the binding layer, SURVEY.md §2)."""

from __future__ import annotations

import os
import subprocess

_NATIVE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def native_lib_path(component: str, libname: str) -> str:
    return os.path.join(_NATIVE_ROOT, component, libname)


def ensure_built(
    component: str, libname: str, quiet: bool = True, also: tuple = ()
) -> str:
    """Build the component with make if its .so — or any of the other
    build outputs named in `also` (e.g. a standalone binary) — is missing
    or older than a source; returns the library path.  Raises RuntimeError
    when the toolchain build fails."""
    path = native_lib_path(component, libname)
    src_dir = os.path.dirname(path)
    srcs = [
        os.path.join(src_dir, f)
        for f in os.listdir(src_dir)
        if f.endswith((".cpp", ".h", ".c"))
    ]
    outs = [path] + [os.path.join(src_dir, o) for o in also]
    stale = any(
        not os.path.exists(o)
        or any(os.path.getmtime(s) > os.path.getmtime(o) for s in srcs)
        for o in outs
    )
    if stale:
        r = subprocess.run(
            ["make", "-C", src_dir],
            capture_output=quiet,
            text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"native build failed for {component}:\n{r.stdout}\n{r.stderr}"
            )
    return path
