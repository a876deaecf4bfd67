"""Peak memory and step time of a config's train step at each checkpointing
level, on a random resident batch, to choose the lowest level that fits.

    python3 -m makani_tpu_torch.tools.checkpoint_levels --yaml_config Y --config NAME \\
        [--levels 0 2 3] [--multistep_count K] [--amp_mode bf16] [--steps 3] [--device cpu]

The model is built as the Trainer builds it (synthetic data, the config's
channel count, batch 1, no validation or checkpoints); each level runs
`--steps` train steps, the first untimed. One JSON line a level: the
parameter count and leaves, the launches of the last step, its loss, each
step's ms (host clock, synchronized) and the peak device memory, or the
out-of-memory error where the level does not fit. Shape overrides
(`--img_shape`, `--embed_dim`, `--num_layers`) cut a config for a test.
"""

import argparse
import json
import time

import torch

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.yparams import YParams


def _params(args, level):
    p = YParams(args.yaml_config, args.config)
    n = len(p.get("channel_names", None) or []) or args.channels
    overrides = dict(
        enable_synthetic_data=True, in_channels=list(range(n)), out_channels=list(range(n)),
        channel_names=[f"c{i}" for i in range(n)], batch_size=1, n_train_samples_per_epoch=1,
        n_eval_samples=1, n_future=args.multistep_count - 1, skip_validation=True,
        save_checkpoint="none", log_video=0, amp_mode=args.amp_mode, checkpointing=level,
        finetune=False, log_to_screen=False, num_data_workers=1)
    if args.img_shape:
        overrides.update(img_shape_x=args.img_shape[0], img_shape_y=args.img_shape[1])
    for key in ("embed_dim", "num_layers"):
        if getattr(args, key):
            overrides[key] = getattr(args, key)
    p.update_params(overrides)
    return p


def measure(args, level, device):
    """One level's record (a dict)."""
    from makani_tpu_torch.utils.trainer import Trainer
    rec = dict(config=args.config, n_future=args.multistep_count - 1, level=level)
    cuda = device.type == "cuda"
    trainer = inp = tar = None
    try:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer(_params(args, level), device=device)
        rec["params"] = sum(v.numel() for v in trainer.model_params.values())
        rec["leaves"] = len(trainer.model_params)
        p = trainer.params
        gen = torch.Generator(device=device).manual_seed(0)
        shape = (p.N_in_channels, p.img_shape_x, p.img_shape_y)
        inp = torch.randn((1, 1, *shape), device=device, generator=gen)
        tar = torch.randn((1, p.n_future + 1, p.N_out_channels, *shape[1:]), device=device,
                          generator=gen)
        times = []
        for step in range(args.steps):
            kernels.reset_launches()
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            loss = trainer.train_step(inp, tar, None, None, 1e-4)
            if cuda:
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        rec.update(launches={k: v for k, v in kernels.launches.items() if v}, loss=float(loss),
                   step_ms=times[1:] or times,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None)
    except torch.cuda.OutOfMemoryError as e:
        rec["out_of_memory"] = str(e).splitlines()[0]
    del trainer, inp, tar
    if cuda:
        torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--yaml_config", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--levels", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--multistep_count", type=int, default=1)
    ap.add_argument("--amp_mode", default="bf16", choices=["none", "bf16", "fp16"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--channels", type=int, default=73,
                    help="channel count where the config names no channels")
    ap.add_argument("--img_shape", type=int, nargs=2)
    ap.add_argument("--embed_dim", type=int)
    ap.add_argument("--num_layers", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    records = []
    for level in args.levels:
        records.append(measure(args, level, device))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
