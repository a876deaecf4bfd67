"""Where the time of one flagship SFNO forward, or one train step, goes on
the GPU.

    python3 -m makani_tpu_torch.tools.profile_forward [--train] [--engine kernel|xla]
                                                      [--top 15] [--trace PATH]

Builds flagship_synth_drive_bare at full width (random weights from a seed),
warms up, then runs one forward (or, with --train, one step of the Trainer on
a resident synthetic batch: forward, backward and the fused Adam update, at
checkpointing 0) under torch.profiler (CPU and CUDA activities), on the
"kernel" coefficient engine or, with --engine xla, on the complex engine with
the complex dhconv kernel on. From the
Chrome trace it prints the wall time, the device's busy time (the union of
kernel, copy and set intervals) and its share of the wall, the device time by
phase (with --train: the kernels inside the step's forward and optimizer
ranges, the rest is backward) and by category (the port's kernels by name,
cuBLAS products by the operator that launched them, those launched inside an
einsum apart, copies, and the rest: elementwise and reductions), then
PyTorch's table by operator and
kernel. --trace PATH keeps the trace at PATH (default
build/profile_trace.json).
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_OWN = {"legmm_kernel": "legmm", "dhconv_kernel": "dhconv_mm", "dhconv_dw_kernel": "dhconv_dw",
        "fused_adam_kernel": "fused_adam", "dhconv_complex_kernel": "dhconv_complex"}
_EINSUM = "einsums (cuBLAS): the complex engine's Legendre contractions and dhconv dw"
_GEMM_OPS = {"aten::bmm": "1x1 channel mixes (cuBLAS bmm)",
             "aten::mm": "longitude DFT (cuBLAS mm)", "aten::addmm": "longitude DFT (cuBLAS mm)"}


def _category(event, ops, einsums):
    name = event["name"]
    for key, label in _OWN.items():
        if key + "<" in name or key + "(" in name:
            return label
    if event["cat"] != "kernel":
        return "copies and sets"
    if "gemm" in name:
        op = ops.get(event["args"].get("External id"))
        if op is None:
            return "other cuBLAS (no operator)"
        if any(a <= op["ts"] <= b for a, b in einsums):
            return _EINSUM
        return _GEMM_OPS.get(op["name"], f"other cuBLAS ({op['name']})")
    return "elementwise, reductions and copies"


def summarize(trace_path, wall_ms):
    """Device time of a Chrome trace by phase and by category, in ms."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    ops = {e["args"].get("External id"): e for e in cpu_ops if "args" in e}
    einsums = [(e["ts"], e["ts"] + e["dur"]) for e in cpu_ops if e["name"] == "aten::einsum"]
    phases = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"}
    busy, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_phase, by_category = defaultdict(float), defaultdict(float)
    for e in device:
        phase = "forward"
        if phases:
            phase = next((name.split(".")[-1] for name, (a, b) in phases.items()
                          if a <= e["ts"] <= b and not name.endswith("backward")), "backward")
        by_phase[phase] += e["dur"] / 1e3
        by_category[_category(e, ops, einsums)] += e["dur"] / 1e3
    print(f"wall {wall_ms:.1f} ms; device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e3 / wall_ms:.1f}% of wall)")
    for title, table in (("phase", by_phase), ("category", by_category)):
        print(f"device ms by {title}:")
        for k, v in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {v:.1f}")
    return busy / 1e3, dict(by_phase), dict(by_category)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile one train step")
    ap.add_argument("--engine", choices=("kernel", "xla"), default="kernel",
                    help="coefficient engine; xla runs with the complex dhconv kernel on")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", type=Path, help="write the Chrome trace to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.utils.yparams import YParams

    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = update_channel_params(
        YParams(str(ROOT / "config" / "sfnonet.yaml"), "flagship_synth_drive_bare"),
        n_channels=73)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sht.set_coeff_engine(args.engine)
    complex_ops.enable_pallas_kernels(args.engine == "xla")
    if args.train:
        from makani_tpu_torch.utils.trainer import Trainer
        params.update_params(dict(enable_synthetic_data=True, n_train_samples_per_epoch=1,
                                  optimizer_fused=True, skip_validation=True,
                                  save_checkpoint="none", checkpointing=0,
                                  coefficient_engine=args.engine))
        trainer = Trainer(params, device=dev)
        inp = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)
        tar = torch.randn((1, params.N_out_channels, 721, 1440), device=dev, generator=gen)

        def run():
            trainer.train_step(inp, tar, None, None, 1e-3)
    else:
        model = get_model(params, device=dev).eval()
        x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)

        @torch.inference_mode()
        def run():
            model(x)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    trace = args.trace or ROOT / "build" / "profile_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"{'train step' if args.train else 'forward'} ({args.engine} engine)", end=": ")
    summarize(trace, wall_ms)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
