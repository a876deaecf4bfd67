"""A whole run of each cell at a tiny size on the CPU (the port's plain
twins stand in for its kernels): the last line's keys and their order, the
metrics each kind of run reports, and the command's refusals."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import ROOT, Spec
from benchmark.run import forbidden_modules, run_cell

C5 = list(range(5))
TINY = {"sfno_train_amp": dict(img_shape_x=37, img_shape_y=72, embed_dim=16, num_layers=3,
                               in_channels=C5, out_channels=C5),
        "afno_rollout_amp": dict(img_shape_x=16, img_shape_y=32, crop_size_x=16,
                                 crop_size_y=32, embed_dim=32, num_layers=2, in_channels=C5,
                                 out_channels=C5, valid_autoreg_steps=3)}
SEED = 2 ** 31 + 12345


def tiny_run(cell, trace, **kw):
    return run_cell(Spec(), cell, SEED, 0.5, trace, "cpu", overrides=TINY[cell],
                    mix_overrides={"coarse": [4, 8]}, **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_untraced_run(cell):
    r = tiny_run(cell, False)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    spec = Spec()
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}
    assert all(m["value"] > 0 or name == "peak_mem_gib" for name, m in r["metrics"].items())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == set(spec.limits(cell))
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run(cell):
    r = tiny_run(cell, True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    # a CPU trace has no device events: only the host-clock share is read
    assert set(r["metrics"]) <= {m["name"] for m in Spec().per_layer(cell)}
    assert any(k.startswith("mfu.") for k in r["metrics"])
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "sfno_train_amp",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "makani_tpu_torch_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]
