"""The fused Adam update over the flagship's parameter leaves on the card.

    python3 -m makani_tpu_torch.tools.bench_fused_adam [--blocks-per-sm N ...] [--reps N]
        [--json PATH]

The leaves are the flagship SFNO's (config/sfnonet.yaml's
flagship_synth_drive_bare, 87 leaves of 572.5 M elements, 73 channels),
random, with gradients of 1e-2 the scale, and bf16 moments under stochastic
rounding. For each
grid size asked for (--blocks-per-sm, where the wrapper takes one) it prints
one JSON line: the update's CUDA-event median over --reps updates after one
warm-up (`ms`, the card waiting on the host where the host is slower), the
same with the update enqueued behind a spin kernel (`device_ms`, the card's
time alone), the host's median time to enqueue an update on an idle card
(`enqueue_ms`), the launches an update, and the bound: the bytes the update
must move (p, g and the two moments read, p and the moments written) over
3.35 TB/s. Then
torch.optim.Adam(fused=True) on the same leaves with float32 moments (what
one PyTorch call takes for the update, never the port's path). The package
imported is whichever is first on the path, so the tool times an older
checkout's kernel from that checkout's root:
`cd OLD && PYTHONPATH=$PWD python3 NEW/makani_tpu_torch/tools/bench_fused_adam.py`.
The card only: it raises without CUDA.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from makani_tpu_torch.ops import fused_adam, kernels

ROOT = Path(__file__).resolve().parents[2]
HBM_BPS = 3.35e12
# ~20 ms at the H100's 1.98 GHz
SPIN_CYCLES = 40_000_000


def leaf_shapes(yaml_config, config, dev):
    """{name: shape} of the config's model, built on `dev` and dropped."""
    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
    from makani_tpu_torch.utils.yparams import YParams
    params = YParams(str(yaml_config), config)
    params["enable_synthetic_data"] = True
    model = get_model(update_channel_params(params, n_channels=73), device=dev)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    return shapes


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """Median milliseconds of `fn` on the card alone: CUDA events around it
    enqueued behind a spin kernel (SPIN_CYCLES, longer than the host takes
    to enqueue it), so the start event completes only once `fn`'s work is
    queued and the card does not wait on the host between the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_adam times the card: CUDA is not available")
    from makani_tpu_torch.utils.optimizers import AdamState
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(340)
    shapes = leaf_shapes(ROOT / "config" / "sfnonet.yaml", "flagship_synth_drive_bare", dev)
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    bf16 = torch.bfloat16
    state = AdamState(0, {k: torch.zeros(s, device=dev, dtype=bf16) for k, s in shapes.items()},
                      {k: torch.zeros(s, device=dev, dtype=bf16) for k, s in shapes.items()})
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, stochastic_rounding=True, seed=340)
    n = sum(math.prod(s) for s in shapes.values())
    # p, g and the two moments read, p and the moments written
    nbytes = n * (4 + 4 + 4 + 2 * 4)
    head = dict(card=card(), leaves=len(shapes), elements=n, bound_ms=nbytes / HBM_BPS * 1e3,
                gbytes=nbytes / 1e9)

    def update():
        fused_adam.fused_adam_apply(params, grads, state, 1e-3, **kw)

    rows = []
    for bps in args.blocks_per_sm or [getattr(fused_adam, "BLOCKS_PER_SM", None)]:
        if bps is not None:
            fused_adam.BLOCKS_PER_SM = bps
        kernels.reset_launches()
        update()
        torch.cuda.synchronize()
        launches = kernels.launches["fused_adam"]
        rows.append(dict(head, blocks_per_sm=bps, launches=launches,
                         ms=cuda_ms(update, args.reps), device_ms=device_ms(update, args.reps),
                         enqueue_ms=enqueue_ms(update, args.reps)))
        print(json.dumps(rows[-1]), flush=True)
    leaves = list(params.values())
    for p, g in zip(leaves, grads.values()):
        p.grad = g
    del state
    torch.cuda.empty_cache()
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
    rows.append(dict(head, library="torch.optim.Adam(fused=True), float32 moments",
                     ms=cuda_ms(opt.step, args.reps), device_ms=device_ms(opt.step, args.reps),
                     enqueue_ms=enqueue_ms(opt.step, args.reps)))
    print(json.dumps(rows[-1]), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
