"""Where the time of one flagship SFNO forward, or one train step, goes on
the GPU.

    python3 -m makani_tpu_torch.tools.profile_forward [--train] [--engine kernel|xla]
                                                      [--amp] [--top 15] [--trace PATH]
                                                      [--yaml_config Y --config NAME]
                                                      [--memory]

Builds flagship_synth_drive_bare (or the config NAME of Y: 73 channels where
it names none; a config that crops, as config/afnonet.yaml's and
config/vit.yaml's do to 720x1440, runs on the crop's grid) at full width
(random weights from a seed),
warms up, then runs one forward (or, with --train, one step of the Trainer on
a resident synthetic batch: forward, backward and the fused Adam update, at
checkpointing 0) under torch.profiler (CPU and CUDA activities), on the
"kernel" coefficient engine or, with --engine xla, on the complex engine with
the complex dhconv kernel on; --amp runs it under bf16 AMP (amp_mode "bf16",
precision "default": a bf16 input, 1 bf16 pass in the kernels). From the
Chrome trace it prints the wall time, the device's busy time (the union of
kernel, copy and set intervals) and its share of the wall, the device time by
phase (with --train: the kernels inside the step's "train_step.forward" and
".optimizer" ranges, the rest is backward; the model's "model.*" spans are
not phases) and by category (the port's kernels by name,
cuBLAS products by the operator that launched them, those launched inside an
einsum apart, copies, and the rest: elementwise and reductions; the SHT's
longitude DFT is gridmm and its table prep, or cuBLAS mm under "highest"),
the peak
device memory of the profiled run, then PyTorch's table by operator and
kernel; for a ViT whose attention runs blockwise, the kernels of its
block steps (the logit tiles' products and elementwise work, forward and
backward) are categories of their own. --trace PATH keeps the trace at PATH (default
build/profile_trace.json). --memory also records the device memory each
operator allocates and does not free within itself, and prints the
operators by that sum: what the run keeps (saved for backward, or
gradients).

The ranges are the port's spans (utils/tracing.py, the one place they come
from): free when no profiler runs, recorded while this tool's profiler does.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the port's kernels by name (csrc/dhconv_gemm.cuh's GEMM serves dhconv_mm on
# stacked planes and dhconv_complex on complex64; each prepares its weight
# with prep_weight first; gridmm, the longitude DFT, prepares its table with
# prep_table)
_OWN = {"legmm_kernel": "legmm", "dhconv_dw_kernel": "dhconv_dw",
        "fused_adam_kernel": "fused_adam", "dhconv_gemm<false": "dhconv_mm",
        "dhconv_gemm<true": "dhconv_complex", "prep_weight": "dhconv weight prep",
        "gridmm_kernel": "gridmm", "prep_table": "gridmm table prep",
        "gelu_bf16_kernel": "gelu_bf16", "gelu_bf16_grad_kernel": "gelu_bf16_grad"}
_EINSUM = "einsums (cuBLAS): the complex engine's Legendre contractions and dhconv dw"
_GEMM_OPS = {"aten::bmm": "1x1 channel mixes (cuBLAS bmm)",
             "aten::mm": "longitude DFT (cuBLAS mm)", "aten::addmm": "longitude DFT (cuBLAS mm)"}
# what the SFNO's products are; another network's are named by operator
_SFNO_LABELS = dict(_GEMM_OPS, einsum=_EINSUM)


def _in_block_step(op, block):
    """Whether a tensor the operator read has `block` among its last two
    dimensions: the attention's block steps (a (.., N, block) logit tile, a
    key block transposed, or a value block); no other tensor of the ViT has
    such a dimension."""
    dims = op["args"].get("Input Dims", []) if op is not None else []
    return any(isinstance(d, list) and block in d[-2:] for d in dims)


def _category(event, ops, einsums, block=None, labels=_SFNO_LABELS):
    name = event["name"]
    for key, label in _OWN.items():
        if any(key + end in name for end in "<(,"):
            return label
    if event["cat"] != "kernel":
        return "copies and sets"
    op = ops.get(event["args"].get("External id"))
    if block is not None and _in_block_step(op, block):
        kind = "cuBLAS" if "gemm" in name or op["name"] in _GEMM_OPS else "elementwise"
        return f"attention block steps ({kind})"
    # a bf16 product's kernel may not say gemm; its operator does
    if "gemm" in name or (op is not None and op["name"] in _GEMM_OPS):
        if op is None:
            return "other cuBLAS (no operator)"
        if any(a <= op["ts"] <= b for a, b in einsums):
            return labels.get("einsum", "einsums (cuBLAS)")
        return labels.get(op["name"], f"cuBLAS ({op['name']})")
    return "elementwise, reductions and copies"


def device_events(trace_path):
    """(all events, the device's events: kernels, copies and sets) of a
    Chrome trace written by torch.profiler."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return events, [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_ms(device):
    """The union of the device events' intervals, in ms: the time the card
    was busy."""
    busy, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def summarize(trace_path, wall_ms, block=None, labels=_SFNO_LABELS):
    """Device time of a Chrome trace by phase and by category, in ms; with
    `block`, the kernels of the attention's block steps (forward, and their
    recomputation and gradients in backward) as categories of their own.
    `labels` names the cuBLAS products by operator (the SFNO's by default)."""
    events, device = device_events(trace_path)
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    ops = {e["args"].get("External id"): e for e in cpu_ops if "args" in e}
    einsums = [(e["ts"], e["ts"] + e["dur"]) for e in cpu_ops if e["name"] == "aten::einsum"]
    phases = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation" and e["name"].startswith("train_step.")}
    busy = busy_ms(device)
    by_phase, by_category = defaultdict(float), defaultdict(float)
    for e in device:
        phase = "forward"
        if phases:
            phase = next((name.split(".")[-1] for name, (a, b) in phases.items()
                          if a <= e["ts"] <= b and not name.endswith("backward")), "backward")
        by_phase[phase] += e["dur"] / 1e3
        by_category[_category(e, ops, einsums, block, labels)] += e["dur"] / 1e3
    print(f"wall {wall_ms:.1f} ms; device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall)")
    for title, table in (("phase", by_phase), ("category", by_category)):
        print(f"device ms by {title}:")
        for k, v in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {v:.1f}")
    return busy, dict(by_phase), dict(by_category)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile one train step")
    ap.add_argument("--engine", choices=("kernel", "xla"), default="kernel",
                    help="coefficient engine; xla runs with the complex dhconv kernel on")
    ap.add_argument("--amp", action="store_true", help="bf16 AMP at precision 'default'")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", type=Path, help="write the Chrome trace to this file")
    ap.add_argument("--yaml_config", default=str(ROOT / "config" / "sfnonet.yaml"))
    ap.add_argument("--config", default="flagship_synth_drive_bare")
    ap.add_argument("--memory", action="store_true",
                    help="print the operators by the device memory they keep")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from makani_tpu_torch.models.common import attention
    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.utils.yparams import YParams

    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = YParams(args.yaml_config, args.config)
    # synthetic data takes the grid as it is: a config's crop becomes its grid
    for axis in ("x", "y"):
        if params.get(f"crop_size_{axis}", None):
            params[f"img_shape_{axis}"] = params[f"crop_size_{axis}"]
    params = update_channel_params(params, n_channels=73)
    shape = (params.img_crop_shape_x, params.img_crop_shape_y)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sht.set_coeff_engine(args.engine)
    complex_ops.enable_pallas_kernels(args.engine == "xla")
    if args.train:
        from makani_tpu_torch.utils.trainer import Trainer
        params.update_params(dict(enable_synthetic_data=True, n_train_samples_per_epoch=1,
                                  batch_size=1,
                                  optimizer_fused=True, skip_validation=True,
                                  save_checkpoint="none", checkpointing=0, log_video=0,
                                  coefficient_engine=args.engine,
                                  amp_mode="bf16" if args.amp else "none"))
        trainer = Trainer(params, device=dev)
        inp = torch.randn((1, params.N_in_channels, *shape), device=dev, generator=gen)
        tar = torch.randn((1, params.N_out_channels, *shape), device=dev, generator=gen)

        def run():
            trainer.train_step(inp, tar, None, None, 1e-3)
    else:
        model = get_model(params, device=dev).eval()
        x = torch.randn((1, params.N_in_channels, *shape), device=dev, generator=gen)
        if args.amp:
            sht.set_transform_precision("default")
            complex_ops.set_contraction_precision("default")
            x = x.to(torch.bfloat16)

        @torch.inference_mode()
        def run():
            model(x)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the ViT's attention block steps are told apart by the shapes their
    # operators read (blockwise beyond 2048 tokens)
    vit = params.nettype == "ViT" and (
        (shape[0] // params.patch_size[0]) * (shape[1] // params.patch_size[1]) > 2048)
    block = attention._DEFAULT_BLOCK_SIZE if vit else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=args.memory, record_shapes=vit) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    trace = args.trace or ROOT / "build" / "profile_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"{'train step' if args.train else 'forward'} ({args.engine} engine"
          f"{', bf16 AMP' if args.amp else ''}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", end=": ")
    summarize(trace, wall_ms, block, _SFNO_LABELS if params.nettype == "SFNO" else {})
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=args.top))
    if args.memory:
        print(prof.key_averages().table(sort_by="self_device_memory_usage",
                                        row_limit=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
