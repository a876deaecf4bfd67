"""The output check must fail what it exists to catch. At a tiny size on the
CPU, against the cells' own limits: a run whose timed path is broken
underneath (a train step that leaves the state unchanged; a forecast step
whose answer is altered where it is produced) comes out not correct, and
so does the control, the reference with its products in float8 e4m3 put in
the program's place. (On the card, at the cells' sizes, the control's
readings are taken by benchmark/calibrate.py; PERF.md keeps them.)"""

import torch

from benchmark.calibrate import control_forecast, control_train
from benchmark.harness.spec import Spec, load_reference
from benchmark.tests.test_bench_result import TINY, tiny_run
from makani_tpu_torch.utils.inferencer import Inferencer
from makani_tpu_torch.utils.trainer import Trainer


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(Trainer, "apply_updates", lambda self, grads, lr: None)
    r = tiny_run("sfno_train_amp", False)
    assert r["checks"]["change_norm_gap"]["value"] == 1.0
    assert r["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    step = Inferencer.lite_step

    def altered(self, inpt, uinp, zen_tar, idt):
        pred, nxt, uinp = step(self, inpt, uinp, zen_tar, idt)
        if idt == 1:
            pred = pred.clone()
            pred[:, 0] = 0.0
        return pred, nxt, uinp

    monkeypatch.setattr(Inferencer, "lite_step", altered)
    r = tiny_run("afno_rollout_amp", False)
    assert r["correct"] is False


def _setup(cell):
    spec = Spec()
    entry = spec.cell(cell)
    config = spec.config(entry["config"])
    params = dict(config["params"], **TINY[cell])
    mix = dict(spec.traffic(entry["traffic"]), coarse=[4, 8])
    return params, mix, load_reference(config["reference"]), spec.limits(cell)


def test_the_train_control_fails():
    params, mix, ref, limits = _setup("sfno_train_amp")
    checks = control_train(params, mix, ref, 2 ** 31 + 7, torch.device("cpu"))
    assert any(checks[k] > limits[k] for k in limits), checks


def test_the_forecast_control_fails():
    params, mix, ref, limits = _setup("afno_rollout_amp")
    checks = control_forecast(params, mix, ref, 2 ** 31 + 8, torch.device("cpu"), 4)
    assert checks["step_gap"] > limits["step_gap"], checks
