"""The port's spans and host-lead counter (utils/tracing.py) on the CPU.

Spans: with no profiler running, no `record_function` is entered, by the
model's spans or the Trainer's; under a CPU torch.profiler session the SFNO's
and AFNO v2's "model.norm", "model.filter" and "model.mlp" ranges land in the
exported trace, as many as the blocks have, each inside the step's
"train_step.*" range and none inside another. tools/profile_forward.py keeps
the "model.*" spans out of its phases.

The host lead: a stand-in for torch.cuda.Event records a device time given
by the test, and the host clock is patched, so the rule (the offset device
time less host time, from the run's first unit, less the run's smallest
offset) is checked on known pairs; on the CPU nothing is recorded.

    python -m pytest tests/test_torch_port_tracing.py -q
"""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from makani_tpu_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet
from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
from makani_tpu_torch.tools import profile_forward
from makani_tpu_torch.utils import tracing

SFNO = dict(inp_shape=(17, 32), out_shape=(17, 32), scale_factor=2, inp_chans=3, out_chans=3,
            embed_dim=8, num_layers=2, operator_type="dhconv",
            normalization_layer="instance_norm", use_mlp=True, mlp_ratio=2.0)
AFNO = dict(inp_shape=(16, 32), patch_size=(4, 8), inp_chans=3, out_chans=3, embed_dim=16,
            num_layers=3, num_blocks=4)
# spans a block runs: SFNO filter, norm0, MLP, norm1; AFNO v2 norm1, filter, norm2, MLP
NETS = {"sfno": (SphericalFourierNeuralOperatorNet, SFNO, (17, 32)),
        "afno_v2": (AdaptiveFourierNeuralOperatorNet, AFNO, (16, 32))}


def _net(kind):
    cls, kw, hw = NETS[kind]
    net = cls(**kw, generator=torch.Generator().manual_seed(3))
    x = torch.randn((1, 3, *hw), generator=torch.Generator().manual_seed(4))
    return net, x


def _step(net, x):
    with tracing.span("train_step.forward"):
        loss = net(x).square().mean()
    with tracing.span("train_step.backward"):
        loss.backward()


class Counter:
    """A record_function stand-in that counts its uses."""

    def __init__(self):
        self.calls = 0

    def __call__(self, name):
        self.calls += 1
        return tracing._Idle(name)


def test_no_profiler_enters_no_record_function(monkeypatch):
    counter = Counter()
    monkeypatch.setattr(tracing, "record_function", counter)

    @tracing.span("test.decorated")
    def decorated(v):
        return v + 1

    with tracing.span("test.context"):
        assert decorated(1) == 2
    for kind in NETS:
        _step(*_net(kind))
    assert counter.calls == 0
    # one shared do-nothing context a name
    assert tracing.span("test.context") is tracing.span("test.context")
    assert tracing.span("test.context") is not tracing.span("test.other")


def test_a_decorator_opens_its_range_at_each_call_under_a_profiler(monkeypatch):
    counter = Counter()
    monkeypatch.setattr(tracing, "record_function", counter)

    @tracing.span("test.decorated")
    def decorated(v):
        return v + 1

    with profile(activities=[ProfilerActivity.CPU]):
        decorated(1)
        decorated(2)
    decorated(3)
    assert counter.calls == 2


def _ranges(path, prefix):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("kind", sorted(NETS))
def test_spans_in_a_cpu_profile(kind, tmp_path):
    net, x = _net(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(net, x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    model = _ranges(path, "model.")
    steps = {e["name"]: e for e in _ranges(path, "train_step.")}
    layers = NETS[kind][1]["num_layers"]
    names = [e["name"] for e in model]
    assert {n: names.count(n) for n in set(names)} == {
        "model.norm": 2 * layers, "model.filter": layers, "model.mlp": layers}
    # in the forward, and no model span inside another
    assert all(_inside(e, steps["train_step.forward"]) for e in model)
    assert not any(_inside(a, b) for a in model for b in model if a is not b)
    # each span's forward ops carry the sequence numbers of their nodes,
    # which the backward's ops carry too
    events = json.loads(path.read_text())["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and "Sequence number" in e["args"]]
    bwd = {e["args"]["Sequence number"] for e in ops
           if e["name"].startswith("autograd::engine::evaluate_function:")}
    for span in model:
        fwd = {e["args"]["Sequence number"] for e in ops if _inside(e, span)}
        assert fwd & bwd, span["name"]


def test_the_trainers_optimizer_range_gates_at_each_call(monkeypatch):
    from makani_tpu_torch.utils.trainer import Trainer
    counter = Counter()
    monkeypatch.setattr(tracing, "record_function", counter)
    updates = []
    owner = SimpleNamespace(fused_kw=None, opt_state=(), model_params={},
                            optimizer=SimpleNamespace(update=lambda g, s, p: (g, s)))
    monkeypatch.setattr("makani_tpu_torch.utils.trainer.apply_updates",
                        lambda params, u, lr: updates.append(lr))
    Trainer.apply_updates(owner, {}, 0.1)
    assert counter.calls == 0
    with profile(activities=[ProfilerActivity.CPU]):
        Trainer.apply_updates(owner, {}, 0.2)
    assert counter.calls == 1 and updates == [0.1, 0.2]


def test_profile_forward_phases_leave_model_spans_out(tmp_path):
    ev = [{"name": "train_step.forward", "cat": "gpu_user_annotation", "ts": 0, "dur": 100},
          {"name": "model.norm", "cat": "gpu_user_annotation", "ts": 10, "dur": 20},
          {"name": "train_step.optimizer", "cat": "gpu_user_annotation", "ts": 300, "dur": 50},
          {"name": "k_norm", "cat": "kernel", "ts": 15, "dur": 10, "args": {}},
          {"name": "k_back", "cat": "kernel", "ts": 150, "dur": 10, "args": {}},
          {"name": "fused_adam_kernel<1>", "cat": "kernel", "ts": 310, "dur": 10, "args": {}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    _, phases, _ = profile_forward.summarize(path, 1.0)
    assert phases == pytest.approx({"forward": 0.01, "backward": 0.01, "optimizer": 0.01})


class FakeEvent:
    """torch.cuda.Event's stand-in: `record` takes the next device time (ms)
    of `FakeEvent.times`; `query` says whether the test made it complete."""

    times = []
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t, self.done = FakeEvent.times.pop(0), False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


@pytest.fixture
def fake(monkeypatch):
    """Units marked at given (device ms, host ms) pairs: returns mark(pairs),
    which marks them in turn and returns their events."""
    tracing.reset()
    FakeEvent.times, FakeEvent.made = [], 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    clock = []
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: clock.pop(0))
    def mark(pairs, loop="train", done=True, device=torch.device("cuda")):
        events = []
        for device_ms, host_ms in pairs:
            FakeEvent.times.append(device_ms)
            clock.append(int(host_ms * 1e6))
            tracing.mark(loop, device)
            events.append(tracing._LOOPS[loop].pending[-1][0])
            events[-1].done = done
        return events

    yield mark
    tracing.reset()


def test_leads_on_known_pairs(fake):
    # the card idle at units 0 and 3, the host 2 and 5 ms ahead at 1 and 2
    fake([(100.0, 50.0), (112.0, 60.0), (125.0, 70.0), (180.0, 130.0)])
    tracing.settle("train")
    assert tracing.leads("train") == pytest.approx([0.0, 2.0, 5.0, 0.0])


def test_the_smallest_offset_may_come_late(fake):
    # the first unit was itself queued 7 ms: the run's least is unit 3's
    fake([(100.0, 50.0), (105.0, 56.0), (110.0, 60.0), (150.0, 107.0)])
    tracing.settle("train")
    assert tracing.leads("train") == pytest.approx([7.0, 6.0, 7.0, 0.0])


def test_pending_units_wait_for_their_event(fake):
    events = fake([(100.0, 50.0), (103.0, 51.0)], done=False)
    tracing.settle("train")
    assert tracing.leads("train") == []
    events[0].done = True
    tracing.settle("train")
    assert tracing.leads("train") == pytest.approx([0.0])
    # in order, and each at the next mark: a later unit waits for an earlier one
    events[1].done = True
    later = fake([(110.0, 60.0)], done=False)
    assert tracing.leads("train") == pytest.approx([0.0, 2.0])
    later[0].done = True
    tracing.settle("train")
    assert tracing.leads("train") == pytest.approx([0.0, 2.0, 0.0])


def test_events_are_reused_and_bounded(fake, monkeypatch):
    monkeypatch.setattr(tracing, "KEEP", 5)
    fake([(10.0 * i, 10.0 * i) for i in range(12)])
    tracing.settle("train")
    # the first unit's event is the run's reference, the rest cycle
    assert FakeEvent.made == 2
    assert tracing.leads("train") == pytest.approx([0.0] * 5)


def test_a_unit_past_the_pending_cap_goes_unmarked(fake, monkeypatch):
    monkeypatch.setattr(tracing, "PENDING", 3)
    fake([(1.0 * i, 1.0 * i) for i in range(4)], done=False)
    assert len(tracing._LOOPS["train"].pending) == 3
    # the fourth unit recorded no event: its device time was never taken
    assert FakeEvent.times == [3.0] and FakeEvent.made == 3


def test_loops_are_apart_and_a_new_device_starts_a_run(fake):
    fake([(100.0, 50.0), (110.0, 55.0)], loop="serve")
    fake([(10.0, 10.0)], loop="train")
    tracing.settle("serve")
    tracing.settle("train")
    assert tracing.leads("serve") == pytest.approx([0.0, 5.0])
    assert tracing.leads("train") == pytest.approx([0.0])
    assert tracing.leads("nothing") == []
    fake([(500.0, 20.0)], loop="serve", device=torch.device("cuda", 1))
    tracing.settle("serve")
    assert tracing.leads("serve") == pytest.approx([0.0])


def test_the_cpu_records_no_lead():
    tracing.reset()
    for _ in range(3):
        tracing.mark("train", torch.device("cpu"))
        tracing.mark("serve", torch.device("cpu"))
    tracing.settle("serve")
    assert tracing.leads("train") == tracing.leads("serve") == []
    assert tracing._LOOPS == {}
