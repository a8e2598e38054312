"""Bench health lane (round-4 verdict #1): every committed bench must RUN at
HEAD.  Round 4 published a G-sweep whose bench then crashed (`frag_nblk`
missing from synth batches) because nothing in the suite exercised any
bench's code path — this lane closes that class of breakage.

Each bench supports --smoke / BENCH_SMOKE=1: micro shapes, 1 rep, CPU
backend.  The test runs the bench as a subprocess and asserts exit 0 plus a
parseable JSON result line carrying "metric".
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCHES = [
    "bench.py",
    "bench/config_c.py",
    "bench/config_d.py",
    "bench/longread_throughput.py",
    "bench/scaling_genome.py",
    "bench/stream_throughput.py",
]


@pytest.mark.slow
@pytest.mark.parametrize("script", BENCHES, ids=[os.path.basename(b) for b in BENCHES])
def test_bench_runs_at_head(script, tmp_path):
    env = dict(os.environ)
    env["BENCH_SMOKE"] = "1"
    env["BENCH_CACHE"] = str(tmp_path / "cache")
    env["JAX_PLATFORMS"] = "cpu"
    # subprocesses must not inherit the suite's forced CPU XLA_FLAGS twice;
    # scaling_genome sets its own device count, the rest are single-device
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, script), "--smoke"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert p.returncode == 0, (
        f"{script} crashed in --smoke mode:\n--- stdout ---\n{p.stdout[-4000:]}"
        f"\n--- stderr ---\n{p.stderr[-4000:]}"
    )
    lines = [l for l in p.stdout.strip().splitlines() if l.strip()]
    assert lines, f"{script} printed no result line"
    result = json.loads(lines[-1])
    assert "metric" in result, f"{script} result line lacks 'metric': {result}"
