"""The ctypes signatures of ops/kernels.py against the C launchers in
makani_tpu_torch/csrc/, read from the sources: no nvcc, no card. Also the
source edits of the ablation tools (tools/*_ablation.py) against the
kernels' sources, their reading of ptxas's report, and the check of
kernel_isolate.device_ms on the profiler's records.

Each kernel's `<name>_launch` is bound through ctypes with the argument types
that `kernels._declare` sets. A launcher whose C signature changes on one
side only would pass its arguments shifted or cut (a pointer passed as a
32-bit int), which no CPU test of the plain twins could see.
"""

import ctypes
import re
from types import SimpleNamespace

import pytest

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.tools import (_ablation, adam_ablation, dhconv_ablation, legmm_ablation,
                                    probe_ablation)

_LAUNCHER = re.compile(r'extern "C" int (\w+)_launch\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32, "unsigned": ctypes.c_uint32,
            "float": ctypes.c_float}


def _param_types(params):
    """The ctypes type each C parameter of a launcher needs: c_void_p for a
    pointer (the stream included), else the scalar's type."""
    types = []
    for param in " ".join(params.split()).split(","):
        if "*" in param:
            types.append(ctypes.c_void_p)
        else:
            decl = param.strip().rsplit(" ", 1)[0]   # drop the parameter's name
            types.append(_SCALARS[decl.replace("const ", "").strip()])
    return types


def _c_launchers():
    """name -> (source, parameter types) of every launcher in csrc/."""
    return {name: (src.name, _param_types(params))
            for src in sorted(kernels._CSRC.glob("*.cu"))
            for name, params in _LAUNCHER.findall(src.read_text())}


C_LAUNCHERS = _c_launchers()


def _declared(name):
    """argtypes and restype as _declare sets them, on a stub library."""
    fn = SimpleNamespace()
    lib = SimpleNamespace(**{f"{name}_launch": fn})
    assert kernels._declare(name, lib) is fn
    return fn.argtypes, fn.restype


@pytest.mark.parametrize("name", sorted(kernels._SOURCES))
def test_ctypes_signature_matches_c_launcher(name):
    assert name in C_LAUNCHERS, f"no extern \"C\" int {name}_launch in csrc/"
    src, c_types = C_LAUNCHERS[name]
    assert src == kernels._SOURCES[name]
    argtypes, restype = _declared(name)
    assert restype is ctypes.c_int
    assert len(argtypes) == len(c_types), (name, len(argtypes), len(c_types))
    for i, (got, want) in enumerate(zip(argtypes, c_types)):
        assert got is want, f"{name}_launch argument {i}: ctypes {got.__name__}, C {want.__name__}"


def test_every_c_launcher_is_declared():
    assert sorted(C_LAUNCHERS) == sorted(kernels._SOURCES)


def test_parser_reads_pointer_and_scalar_types():
    src = 'extern "C" int k_launch(const void* a, void *b, int n,\n    uint32_t s, float f) {'
    [(name, params)] = _LAUNCHER.findall(src)
    assert name == "k"
    assert _param_types(params) == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_uint32, ctypes.c_float]


@pytest.mark.parametrize("variant", sorted(legmm_ablation.VARIANTS))
def test_ablation_edits_apply_to_the_sources(variant):
    """tools/legmm_ablation.py rebuilds legmm with parts switched off by text
    edits of its sources: each edit must find its text exactly once."""
    texts = _ablation.edited_sources(legmm_ablation.SOURCES, legmm_ablation.VARIANTS[variant])
    originals = {f: (kernels._CSRC / f).read_text() for f in legmm_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in legmm_ablation.VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(dhconv_ablation.VARIANTS))
def test_dhconv_ablation_edits_apply_to_the_sources(variant):
    """tools/dhconv_ablation.py rebuilds dhconv_mm with parts switched off in
    the same way: each edit must find its text exactly once."""
    texts = _ablation.edited_sources(dhconv_ablation.SOURCES, dhconv_ablation.VARIANTS[variant])
    originals = {f: (kernels._CSRC / f).read_text() for f in dhconv_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in dhconv_ablation.VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(dhconv_ablation.DW_VARIANTS))
def test_dhconv_dw_ablation_edits_apply_to_the_sources(variant):
    """tools/dhconv_ablation.py dw rebuilds dhconv_dw with parts switched off
    in the same way: each edit must find its text exactly once."""
    texts = _ablation.edited_sources(dhconv_ablation.DW_SOURCES,
                                     dhconv_ablation.DW_VARIANTS[variant])
    originals = {f: (kernels._CSRC / f).read_text() for f in dhconv_ablation.DW_SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in dhconv_ablation.DW_VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(probe_ablation.VARIANTS))
def test_probe_ablation_edits_apply_to_the_source(variant):
    """tools/probe_ablation.py rebuilds probes.cu with gridded_kernel's parts
    switched off or its tile changed: each edit must find its text once."""
    texts = _ablation.edited_sources(probe_ablation.SOURCES, probe_ablation.VARIANTS[variant])
    originals = {f: (kernels._CSRC / f).read_text() for f in probe_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in probe_ablation.VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(probe_ablation.DOT_VARIANTS))
def test_dot_ablation_edits_apply_to_the_source(variant):
    """probe_ablation's dot family rebuilds probes.cu with
    probe_dot_plain_kernel's parts switched off, its tile changed or its
    operands in registers: each edit must find its text once."""
    edits = probe_ablation.DOT_VARIANTS[variant]
    texts = _ablation.edited_sources(probe_ablation.SOURCES, edits)
    originals = {f: (kernels._CSRC / f).read_text() for f in probe_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in edits}


@pytest.mark.parametrize("family,variant", [
    (f, v) for f in ("transposed", "split")
    for v in sorted(probe_ablation.DOT_FAMILIES[f].variants)])
def test_probe_family_ablation_edits_apply_to_the_source(family, variant):
    """probe_ablation's transposed and split families rebuild probes.cu with
    probe_dot_kernel's or probe_bf16_split_kernel's parts switched off or
    their tiles changed: each edit must find its text once, and every
    variant that computes is one the family checks bit for bit."""
    fam = probe_ablation.DOT_FAMILIES[family]
    edits = fam.variants[variant]
    texts = _ablation.edited_sources(probe_ablation.SOURCES, edits)
    originals = {f: (kernels._CSRC / f).read_text() for f in probe_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in edits}
    assert fam.probe in kernels._SOURCES and set(fam.computing) - {"parent"} <= set(fam.variants)


@pytest.mark.parametrize("variant", sorted(adam_ablation.VARIANTS))
def test_adam_ablation_edits_apply_to_the_source(variant):
    """tools/adam_ablation.py rebuilds fused_adam.cu with parts switched off
    in the same way: each edit must find its text once."""
    texts = _ablation.edited_sources(adam_ablation.SOURCES, adam_ablation.VARIANTS[variant])
    originals = {f: (kernels._CSRC / f).read_text() for f in adam_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in adam_ablation.VARIANTS[variant]}


def test_ptxas_usage_reads_each_instantiation():
    """The ablation tools print ptxas's registers and spills for every
    instantiation of a kernel, not the first one the log names."""
    log = """ptxas info    : Compiling entry function '_Z14gridded_kernelILb1EEvPKfS1_PfS2_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z14gridded_kernelILb1EEvPKfS1_PfS2_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z17probe_copy_kernelPKfPfi' for 'sm_90a'
ptxas info    : Used 8 registers
ptxas info    : Compiling entry function '_Z14gridded_kernelILb0EEvPKfS1_PfS2_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z14gridded_kernelILb0EEvPKfS1_PfS2_iiiiii
    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers
"""
    assert _ablation.ptxas_usage(log, "gridded_kernel") == [
        ("_Z14gridded_kernelILb1EEvPKfS1_PfS2_iiiiii", 32, 0),
        ("_Z14gridded_kernelILb0EEvPKfS1_PfS2_iiiiii", 30, 12)]


@pytest.mark.parametrize("sessions,want", [
    # (records of one call, durations of the reps calls) per try
    ([(1, [2.0] * 4)], 2e-3),
    ([(1, [2.0] * 2), (1, [3.0] * 4)], 3e-3),
    ([(2, [1.0] * 8)], 2e-3),
    ([(0, []), (1, [2.0] * 4)], 2e-3),
    ([(1, [2.0] * 3)] * 3, None)])
def test_device_ms_discards_sessions_that_lost_records(monkeypatch, sessions, want):
    """device_ms keeps a profiler session only when its 4 calls left 4 times
    the records of one call; else it takes another, and raises after three."""
    from makani_tpu_torch.tools import kernel_isolate
    queue = [r for n, durs in sessions for r in ([1.0] * n, durs)]
    monkeypatch.setattr(kernel_isolate, "_device_records", lambda fn, reps: queue.pop(0))
    monkeypatch.setattr(kernel_isolate.torch.cuda, "synchronize", lambda: None)
    before = kernel_isolate.discarded_sessions
    if want is None:
        with pytest.raises(RuntimeError, match="three times"):
            kernel_isolate.device_ms(lambda: None, 4)
    else:
        assert kernel_isolate.device_ms(lambda: None, 4) == pytest.approx(want)
        assert kernel_isolate.discarded_sessions == before + len(sessions) - 1


def test_fused_adam_launcher_takes_the_norm_the_direction_and_the_mode():
    """fused_adam_launch's parameters by name, against the ctypes types at
    their positions: the table of the leaves' descriptors (each holding its
    leaf's p, g, mu, nu and direction addresses, LeafDesc), the counts of
    leaves and work units and the grid, the device pointer to the global
    norm, max_norm and wd after the nine update scalars, the mode after the
    moment kind."""
    src = (kernels._CSRC / "fused_adam.cu").read_text()
    [(name, params)] = [m for m in _LAUNCHER.findall(src) if m[0] == "fused_adam"]
    names = [" ".join(p.split()).replace("*", " ").split()[-1] for p in params.split(",")]
    assert names == ["leaves", "n_leaves", "n_units", "blocks", "norm", "lr", "bc1", "bc2", "b1",
                     "b2", "a1", "a2", "eps", "decay", "max_norm", "wd", "kind", "mode", "stream"]
    argtypes, _ = _declared("fused_adam")
    want = {"leaves": ctypes.c_void_p, "n_leaves": ctypes.c_int, "n_units": ctypes.c_uint32,
            "blocks": ctypes.c_int, "norm": ctypes.c_void_p, "max_norm": ctypes.c_float,
            "wd": ctypes.c_float, "kind": ctypes.c_int, "mode": ctypes.c_int,
            "stream": ctypes.c_void_p}
    for key, ctype in want.items():
        assert argtypes[names.index(key)] is ctype, key


_C_FIELD_BYTES = {"uint64_t": 8, "uint32_t": 4}


def _c_struct_fields(src, struct):
    """[(name, offset, size)] of a C struct of fixed-width unsigned fields,
    each at the next multiple of its size, and the struct's size (rounded to
    its widest field), read from the source."""
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    fields, offset, widest = [], 0, 1
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        size = _C_FIELD_BYTES[ctype]
        widest = max(widest, size)
        for field in names.split(","):
            offset = -(-offset // size) * size
            fields.append((field.strip(), offset, size))
            offset += size
    return fields, -(-offset // widest) * widest


def test_fused_adam_descriptor_layout_matches_the_source():
    """ops/fused_adam.LEAF_DTYPE, the rows the wrapper copies to the card,
    against csrc/fused_adam.cu's LeafDesc read from the source: every field's
    name, offset and width, the struct's size, and the size its
    static_assert pins; and the work unit and run length the wrapper counts
    in against the kernel's."""
    from makani_tpu_torch.ops import fused_adam
    src = (kernels._CSRC / "fused_adam.cu").read_text()
    fields, size = _c_struct_fields(src, "LeafDesc")
    dtype = fused_adam.LEAF_DTYPE
    assert [f for f, _, _ in fields] == list(dtype.names)
    for name, offset, width in fields:
        ftype, foffset = dtype.fields[name][:2]
        assert (foffset, ftype.itemsize, ftype.kind, ftype.byteorder in "<=|") == (
            offset, width, "u", True), name
    assert size == dtype.itemsize == 120
    assert f"static_assert(sizeof(LeafDesc) == {dtype.itemsize}," in src
    assert f"constexpr uint32_t kVec = {fused_adam.VEC};" in src
    assert "constexpr int kThreads = 256;" in src and fused_adam.UNIT == 256 * fused_adam.VEC
    assert "constexpr uint32_t kUnit = kThreads * kVec;" in src


def test_c_struct_parser_reads_offsets():
    fields, size = _c_struct_fields(
        "struct S {\n  uint32_t a;  // x\n  uint64_t b, c;\n  uint32_t d;\n};", "S")
    assert fields == [("a", 0, 4), ("b", 8, 8), ("c", 16, 8), ("d", 24, 4)] and size == 32


def test_fused_adam_moment_kinds():
    """The moment kind the wrapper passes for each moment dtype, against the
    kinds fused_adam_launch takes: 0 float32, 1 and 2 bf16 (to nearest,
    stochastically), 3 float16 (to nearest, asked for stochastic rounding
    or not); the launcher refuses any other kind and dispatches each of the
    four to its own instantiation, whose moment type is read from Moment<>."""
    import torch
    from makani_tpu_torch.ops import fused_adam
    src = (kernels._CSRC / "fused_adam.cu").read_text()
    kinds = {(torch.float32, False): 0, (torch.bfloat16, False): 1, (torch.bfloat16, True): 2,
             (torch.float16, False): 3, (torch.float16, True): 3}
    for (dtype, stochastic), kind in kinds.items():
        assert fused_adam._moment_kind(torch.zeros(1, dtype=dtype), stochastic) == kind
    with pytest.raises(TypeError, match="float16"):
        fused_adam._moment_kind(torch.zeros(1, dtype=torch.float64), False)
    assert "kind < 0 || kind > 3" in src
    for kind in range(4):
        assert f"launch_mode<{kind}>(a, k, mode, s)" in src
    assert "KIND == 3, __half, __nv_bfloat16" in src and "__float2half_rn(v)" in src
