"""What the ablation tools (tools/*_ablation.py) share: a kernel's sources
rebuilt with text edits, one nvcc a variant, all started together, and the
compiler's resource report read for each instantiation of a kernel."""

import ctypes
import re
import subprocess
from pathlib import Path

from makani_tpu_torch.ops import kernels


def edited_sources(sources, edits, csrc=kernels._CSRC):
    """{file name: text} of `sources` in `csrc` with `edits` applied: each
    (file, text, replacement), the text present exactly once."""
    texts = {f: (Path(csrc) / f).read_text() for f in sources}
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"{old!r} is not once in {f}")
        texts[f] = texts[f].replace(old, new)
    return texts


def build_variants(subdir, sources, variants, names, parent=None):
    """Writes each variant's sources ({variant: edits}; sources[0] is the one
    compiled) into build/kernels/<subdir>/<variant>/ and builds it, all nvcc
    started together; a header not among `sources` is read from the csrc
    directory the variant came from. With `parent`, a csrc directory of
    another checkout, its sources unedited are built as the variant
    "parent". Returns
    ({variant: {kernel name: launcher}}, {variant: nvcc's log})."""
    root = kernels.BUILD_DIR / subdir
    todo = {v: (kernels._CSRC, edits) for v, edits in variants.items()}
    if parent is not None:
        todo["parent"] = (Path(parent), [])
    procs = {}
    for variant, (csrc, edits) in todo.items():
        d = root / variant
        d.mkdir(parents=True, exist_ok=True)
        for f, text in edited_sources(sources, edits, csrc).items():
            (d / f).write_text(text)
        lib = d / f"lib{Path(sources[0]).stem}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(d), "-I", str(csrc), "-o",
               str(lib), str(d / sources[0])]
        procs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    launchers, logs = {}, {}
    for variant, (lib, proc) in procs.items():
        logs[variant], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{variant} build failed\n{logs[variant]}")
        so = ctypes.CDLL(str(lib))
        launchers[variant] = {name: kernels._declare(name, so) for name in names}
    return launchers, logs


def ptxas_usage(log, kernel):
    """[(mangled entry, registers, spill store bytes)] of each instantiation
    of `kernel` in an nvcc log with -Xptxas -v."""
    usage = []
    for seg in log.split("Compiling entry function '")[1:]:
        entry = seg[:seg.index("'")]
        if kernel in entry:
            regs, spill = (re.search(pat, seg) for pat in (r"Used (\d+) registers",
                                                           r"(\d+) bytes spill stores"))
            usage.append((entry, regs and int(regs[1]), spill and int(spill[1])))
    return usage
