"""The port's one launch path (ops/kernels.py `launch`, `stream`,
`torch._C._cuda_getDevice`) and the wrappers that take it, on the CPU: no card,
no nvcc.

A wrapper sends CPU tensors to its plain twin (`dispatch`); here `dispatch`
is patched to send them down the kernel path instead, with a recording
launcher in `kernels._libs` in place of the C launcher and stubs in place of
the two CUDA lookups (`kernels.stream`, `torch._C._cuda_getDevice`), which a
CPU build of torch lacks. So each test sees exactly what a wrapper hands the
launcher: the addresses in the C launcher's order, the dims, and the current
stream's handle last, as many arguments as `kernels._declare` declares for
it; and what it counts. On the card the same paths launch
(tests/test_torch_port_cuda.py, `-k "probe or stream"`).

    python -m pytest tests/test_torch_port_launch_path.py -q
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from makani_tpu_torch.ops import complex_kernels, gelu, instance_norm, kernels, spectral_mm
from makani_tpu_torch.tools import bench_gridmm, kernel_isolate

ROOT = Path(__file__).resolve().parents[1]
# the stream handle the stub hands every launch
STREAM = 0x5EED


class Recorder:
    """A C launcher's stand-in: records each call's arguments, returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def path(monkeypatch):
    """Records every launch: {kernel: Recorder}; the stream's device indices
    asked for in `streams`."""
    recorders = {name: Recorder() for name in kernels._SOURCES}
    for name, rec in recorders.items():
        monkeypatch.setitem(kernels._libs, name, rec)
    streams = []
    monkeypatch.setattr(kernels, "stream", lambda index: streams.append(index) or STREAM)
    # a CPU tensor's device index is None: it is "the current device" here
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None, raising=False)
    for module in (kernel_isolate, spectral_mm, gelu, instance_norm, complex_kernels,
                   bench_gridmm):
        monkeypatch.setattr(module, "dispatch", lambda x: True)
    return SimpleNamespace(recorders=recorders, streams=streams)


def _n_args(name):
    """The number of arguments `kernels._declare` declares for `name`'s C
    launcher (its stream included)."""
    fn = SimpleNamespace()
    kernels._declare(name, SimpleNamespace(**{f"{name}_launch": fn}))
    return len(fn.argtypes)


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


def _case(probe):
    return next(c for c in kernel_isolate.CASES if c[0] == probe)


def _expected_dims(probe, inputs):
    if probe == "copy":
        return (inputs[0].numel(),)
    a, b = inputs
    if probe in ("dot_plain", "dot_transposed", "bf16_split"):
        o = a.shape[1] if probe != "dot_plain" else a.shape[0]
        return (o, b.shape[0], b.shape[1])
    x, w = inputs
    return (x.shape[0], x.shape[1], x.shape[2], w.shape[2], x.shape[3])


PROBE_SHAPES = {"copy": [(5, 31)], "dot_plain": [(3, 5), (5, 7)],
                "dot_transposed": [(5, 3), (5, 7)], "bf16_split": [(5, 3), (5, 7)],
                "grid_blocks": [(2, 3, 5, 7), (3, 5, 4)],
                "stacked_output_5d": [(2, 3, 5, 7), (3, 5, 4)],
                "multi_output": [(2, 3, 5, 7), (3, 5, 4)]}


@pytest.mark.parametrize("probe", sorted(PROBE_SHAPES))
def test_probe_wrapper_hands_the_launcher_pointers_dims_and_stream(path, probe):
    _, _, kernel, _ = _case(probe)
    name = kernel.__name__
    inputs = kernel_isolate.case_inputs(PROBE_SHAPES[probe], 0, torch.device("cpu"))
    before = dict(kernels.launches)
    got = kernel(*inputs)
    outputs = got if isinstance(got, tuple) else (got,)
    [args] = path.recorders[name].calls
    assert args == (*_ptrs(*inputs, *outputs), *_expected_dims(probe, inputs), STREAM)
    assert len(args) == _n_args(name)
    assert path.streams == [None]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in outputs)
    assert kernels.launches == {**before, name: before[name] + 1}


@pytest.mark.parametrize("transposed", [False, True])
def test_dot_chain_hands_the_launcher_a_by_its_strides(path, transposed):
    """The dot probes' bit reference reads a (O, C) at strides (C, 1) and a
    (C, O) at (1, O), counted as probe_dot_chain."""
    a, b = kernel_isolate.case_inputs([(5, 3) if transposed else (3, 5), (5, 7)], 0,
                                      torch.device("cpu"))
    before = dict(kernels.launches)
    got = kernel_isolate.dot_chain(a, b, transposed=transposed)
    [args] = path.recorders["probe_dot_chain"].calls
    strides = (1, 3) if transposed else (5, 1)
    assert args == (*_ptrs(a, b, got), 3, 5, 7, *strides, STREAM)
    assert len(args) == _n_args("probe_dot_chain")
    assert kernels.launches == {**before, "probe_dot_chain": before["probe_dot_chain"] + 1}


def _refusals():
    f32 = torch.randn
    return {
        "copy non-contiguous": ("copy", lambda: (f32(16, 8).T,)),
        "copy float64": ("copy", lambda: (f32(8, 16).double(),)),
        "dot_plain non-contiguous b": ("dot_plain", lambda: (f32(4, 5), f32(7, 5).T)),
        "dot_plain bfloat16 a": ("dot_plain", lambda: (f32(4, 5).bfloat16(), f32(5, 7))),
        "dot_plain on two devices": ("dot_plain",
                                     lambda: (f32(4, 5), torch.empty((5, 7), device="meta"))),
        "grid_blocks on two devices": ("grid_blocks", lambda: (
            f32(2, 3, 5, 7), torch.empty((3, 5, 4), device="meta"))),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_probe_wrapper_refuses_before_any_launch(path, case):
    probe, make = _refusals()[case]
    _, _, kernel, _ = _case(probe)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="contiguous float32 tensors on one device"):
        kernel(*make())
    assert not any(r.calls for r in path.recorders.values())
    assert path.streams == [] and kernels.launches == before


NO_WORK = [("copy", [(0, 128)]), ("copy", [(8, 0)]), ("dot_plain", [(0, 16), (16, 128)]),
           ("dot_plain", [(16, 0), (0, 128)]), ("dot_transposed", [(0, 16), (0, 128)]),
           ("multi_output", [(2, 4, 0, 128), (4, 0, 16)]),
           ("stacked_output_5d", [(0, 4, 16, 128), (4, 16, 16)])]


@pytest.mark.parametrize("probe,shapes", NO_WORK)
def test_probe_no_work_launches_and_counts_nothing(path, probe, shapes):
    """An empty output, or a contraction of length 0 (zeros): the twin's
    result, no launch, no count, no stream looked up."""
    _, _, kernel, twin = _case(probe)
    inputs = kernel_isolate.case_inputs(shapes, 0, torch.device("cpu"))
    before = dict(kernels.launches)
    got, want = kernel(*inputs), twin(*inputs)
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert not any(r.calls for r in path.recorders.values())
    assert path.streams == [] and kernels.launches == before


def test_launch_path_never_runs_at_import():
    """Importing every module that launches a kernel looks up no CUDA
    function: the two lookups (present or not in this build) raise if
    called, and every import still succeeds."""
    modules = ["makani_tpu_torch.ops." + m for m in
               ("kernels", "spectral_mm", "gelu", "instance_norm", "complex_kernels", "fused_adam",
                "sht")]
    modules += ["makani_tpu_torch.tools." + m for m in
                ("kernel_isolate", "bench_gridmm", "bench_spectral_mm", "launch_path",
                 "legmm_ablation", "dhconv_ablation", "probe_ablation", "adam_ablation")]
    code = "\n".join([
        "import importlib, torch",
        "def called(*args):",
        "    raise RuntimeError('a CUDA lookup ran at import')",
        "torch._C._cuda_getCurrentRawStream = called",
        "torch._C._cuda_getDevice = called",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "print('imported', len(" + repr(modules) + "))",
    ])
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f"imported {len(modules)}"


def test_launch_enters_the_device_context_only_off_the_current_device(path, monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    before = kernels.launches["probe_copy"]
    kernels.launch("probe_copy", 0, 11, 22, 33)
    assert entered == [] and path.recorders["probe_copy"].calls == [(11, 22, 33, STREAM)]
    kernels.launch("probe_copy", 1, 44, 55, 66)
    assert entered == [1] and path.recorders["probe_copy"].calls[-1] == (44, 55, 66, STREAM)
    assert path.streams == [0, 1]
    assert kernels.launches["probe_copy"] == before + 2


def test_launch_raises_on_a_cuda_error_and_counts_nothing(path, monkeypatch):
    monkeypatch.setitem(kernels._libs, "probe_copy", Recorder(rc=700))
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="probe_copy launch failed: CUDA error 700"):
        kernels.launch("probe_copy", None, 1, 2, 3)
    assert kernels.launches == before


def test_launch_counts_by_passes(path):
    before = kernels.launches_by_passes["legmm", 3]
    kernels.launch("legmm", None, *range(10), passes=3)
    assert kernels.launches_by_passes["legmm", 3] == before + 1


def _wrapper_cases():
    """(case id, kernel, call) for each wrapper of ops/ and of the grid dot:
    `call` returns (inputs, output, call's result handed back)."""
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)  # noqa: E731

    def legmm():
        z, p = f(6, 4, 5), f(3, 7, 5)
        return (z, p), spectral_mm.legmm(z, p, 3, "k")

    def dhconv_mm():
        x, w = f(2, 1, 3, 4, 5), f(2, 3, 4, 6)
        return (x, w), spectral_mm.dhconv_mm(x, w, 1)

    def dhconv_dw():
        x, g_ = f(2, 1, 3, 4, 5), f(2, 1, 3, 6, 5)
        return (x, g_), spectral_mm.dhconv_dw(x, g_, 3)

    def gridmm():
        x, t = f(9, 7), f(7, 5)
        return (x, t), spectral_mm.gridmm(x, t, 2)

    def gelu_forward():
        x = f(3, 5).bfloat16()
        return (x,), gelu.gelu_bf16_forward(x)

    def gelu_backward():
        x, g_ = f(3, 5).bfloat16(), f(3, 5).bfloat16()
        return (x, g_), gelu.gelu_bf16_backward(x, g_)

    def norm_forward():
        x, w, b = f(2, 3, 5, 7).bfloat16(), f(3), f(3)
        return (x, w, b), instance_norm.instance_norm_forward(x, w, b, 1e-6)[0]

    def norm_backward():
        x, g_, w, stats = f(2, 3, 5, 7), f(2, 3, 5, 7), f(3), f(2, 2, 3)
        return (x, g_, w, stats), instance_norm.instance_norm_backward(x, g_, w, stats)[0]

    def dhconv_complex():
        x = torch.complex(f(1, 4, 3, 5), f(1, 4, 3, 5))
        w = torch.complex(f(4, 6, 3), f(4, 6, 3))
        return (x, w), complex_kernels.contract_dhconv_raw(x, w, 3)

    def grid_dot():
        x = f(9, 7)
        th, tl = bench_gridmm.split_table(f(7, 6))
        return (x, th, tl), bench_gridmm.grid_dot(x, th, tl)

    return [("legmm", "legmm", legmm), ("dhconv_mm", "dhconv_mm", dhconv_mm),
            ("dhconv_dw", "dhconv_dw", dhconv_dw), ("gridmm", "gridmm", gridmm),
            ("gelu_bf16", "gelu_bf16", gelu_forward),
            ("gelu_bf16_grad", "gelu_bf16_grad", gelu_backward),
            ("instance_norm_fwd", "instance_norm_fwd", norm_forward),
            ("instance_norm_bwd", "instance_norm_bwd", norm_backward),
            ("dhconv_complex", "dhconv_complex", dhconv_complex),
            ("grid_dot", "grid_dot", grid_dot)]


@pytest.mark.parametrize("case", [c[0] for c in _wrapper_cases()])
def test_every_wrapper_takes_the_launch_path(path, case):
    """The inputs' addresses first, the output's among the arguments, the
    current stream's handle last, as many arguments as the C launcher takes,
    and one launch counted."""
    _, name, call = next(c for c in _wrapper_cases() if c[0] == case)
    before = kernels.launches[name]
    inputs, out = call()
    [args] = path.recorders[name].calls
    assert args[:len(inputs)] == _ptrs(*inputs)
    assert out.data_ptr() in args and args[-1] == STREAM
    assert len(args) == _n_args(name)
    assert path.streams == [None]
    assert kernels.launches[name] == before + 1
