"""The command on the card, each cell once untraced and once traced at a
short window: exit 0, a correct last line with every metric the cell owes.

    python3 -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import ROOT, Spec

CELLS = sorted(Spec().cells)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    spec = Spec()
    owed = spec.per_layer(cell) if trace else spec.end_to_end(cell)
    assert {m["name"] for m in owed} <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
