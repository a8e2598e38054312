"""chip_smoke.py off the card: it must refuse to run without a GPU, and
--four must select only the mesh phase."""

import json
import os
import shutil
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ok_lines(stdout: str) -> list:
    out = []
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "ok" in obj:
            out.append(obj)
    return out


def test_cpu_backend_exits_nonzero_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode != 0
    assert not _ok_lines(p.stdout)
    assert "no GPU" in p.stderr


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode != 0
    assert not _ok_lines(p.stdout)


def test_four_selects_only_the_mesh_phase():
    assert chip_smoke.phases(["--four"]) == ["setup", "four"]
    assert chip_smoke.phases([]) == ["setup", "parity", "main", "batch"]
    assert set(chip_smoke.phases([])) | {"four"} == set(chip_smoke.PHASES)
