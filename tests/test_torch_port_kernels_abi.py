"""The ctypes signatures of ops/kernels.py against the C launchers in
makani_tpu_torch/csrc/, read from the sources: no nvcc, no card. Also the
source edits of tools/legmm_ablation.py against the kernel's sources.

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
from makani_tpu_torch.tools import dhconv_ablation, legmm_ablation

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
    texts = legmm_ablation.edited_sources(variant)
    originals = {f: (kernels._CSRC / f).read_text() for f in legmm_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in legmm_ablation.VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(dhconv_ablation.VARIANTS))
def test_dhconv_ablation_edits_apply_to_the_sources(variant):
    """tools/dhconv_ablation.py rebuilds dhconv_mm with parts switched off in
    the same way: each edit must find its text exactly once."""
    texts = dhconv_ablation.edited_sources(variant)
    originals = {f: (kernels._CSRC / f).read_text() for f in dhconv_ablation.SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in dhconv_ablation.VARIANTS[variant]}


@pytest.mark.parametrize("variant", sorted(dhconv_ablation.DW_VARIANTS))
def test_dhconv_dw_ablation_edits_apply_to_the_sources(variant):
    """tools/dhconv_ablation.py dw rebuilds dhconv_dw with parts switched off
    in the same way: each edit must find its text exactly once."""
    texts = dhconv_ablation.edited_sources(variant, "dw")
    originals = {f: (kernels._CSRC / f).read_text() for f in dhconv_ablation.DW_SOURCES}
    changed = {f for f in texts if texts[f] != originals[f]}
    assert changed == {f for f, _, _ in dhconv_ablation.DW_VARIANTS[variant]}
