"""The benchmark of makani_tpu_torch on NVIDIA H100s.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Looks the cell up in BENCHMARK.json, finds its configuration, its traffic
mix, its check limits and its per-layer metrics' readers by name
(harness/spec.py), sets the program up from the seed, measures it for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` (with `--trace 1` also the
device's busy seconds and the traced window's length), with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit,
which also end standard error.

Exits 2 without a result where no CUDA card (or fewer than the cell asks
for) is present or the program is missing, and 3 where the process that
prints the result holds a module of JAX or of the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.harness.spec import ROOT, Spec, load_reader, load_reference  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "makani_tpu")
PROGRAM = "makani_tpu_torch"
TRACE_PATH = ROOT / "build" / "benchmark" / "trace.json"
# compile caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton"}


class Context:
    """What a traffic kind needs of the run."""

    def __init__(self, spec, cell, seed, seconds, trace, device, t0, overrides=None,
                 mix_overrides=None):
        entry = spec.cell(cell)
        config = spec.config(entry["config"])
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device, self.t0 = device, t0
        self.params = dict(config["params"], **(overrides or {}))
        self.reference = load_reference(config["reference"])
        self.mix = dict(spec.traffic(entry["traffic"]), **(mix_overrides or {}))
        self.limits = spec.limits(cell)

    def trace_units(self, mix):
        return int(mix["trace_units"]) if self.trace else 0


class Readings:
    """What the per-layer readers read: the trace of the traced units, the
    work the reference's shapes ask a unit, and the untraced unit time."""

    def __init__(self, ctx, measured, trace):
        from benchmark.harness.peaks import BF16_FLOPS, F32_FLOPS
        batch, train = ctx.mix["batch"], ctx.mix["kind"] == "train"
        self.trace = trace
        self.units = measured["traced_units"]
        self.work = ctx.reference.kernel_work(ctx.params, batch, train)
        self.flops = ctx.reference.model_flops(ctx.params, batch, train)
        win = measured["window"]
        self.unit_s = win.rest_s / measured["rest_units"]
        amp = ctx.params.get("amp_mode", "none") in ("bf16", "fp16")
        self.peak_flops = BF16_FLOPS if amp else F32_FLOPS


def power_limit_w():
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec, cell, seed, seconds, trace, device, t0=None, overrides=None,
             mix_overrides=None, chips=1, worst=False):
    """One run of `cell`; returns the result dict (without printing); with
    `worst`, also where each compared number was read (a leaf, a step)."""
    import torch

    from benchmark.harness.traffic import KINDS

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    ctx = Context(spec, cell, seed, seconds, trace, device, t0, overrides, mix_overrides)
    measured = KINDS[ctx.mix["kind"]](ctx)
    checks = {k: (v, ctx.limits[k]) for k, v in measured["checks"].items()}
    correct = measured["finite"] and all(v <= limit for v, limit in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": measured["peak_bytes"]}
    result = {"correct": bool(correct), "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": {}, "device": dev}
    if trace:
        from benchmark.harness.trace import Trace
        TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
        measured["window"].prof.export_chrome_trace(str(TRACE_PATH))
        tr = Trace(TRACE_PATH)
        TRACE_PATH.unlink()
        readings = Readings(ctx, measured, tr)
        for m in spec.per_layer(cell):
            value = load_reader(m["name"])(readings, m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        e2e = dict(measured["e2e"], setup_s=measured["setup_s"],
                   peak_mem_gib=measured["peak_bytes"] / 2 ** 30)
        for m in spec.end_to_end(cell):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if worst:
        result["worst"] = measured["worst"]
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result


def forbidden_modules():
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    spec = Spec()
    cell = spec.cell(args.workload)
    import importlib.util

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t0=T0, chips=cell["chips"])
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
