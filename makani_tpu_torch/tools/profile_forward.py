"""Where the time of one flagship SFNO forward goes, on the GPU.

    python3 -m makani_tpu_torch.tools.profile_forward [--top 15] [--trace PATH]

Builds flagship_synth_drive_bare at full width (random weights from a seed),
warms up, then runs one forward under torch.profiler (CPU and CUDA
activities) and prints the device time by operator and by kernel, the
forward's wall time and the device's busy share of it. --trace PATH writes
the Chrome trace to PATH.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", type=Path, help="write the Chrome trace to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
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
    model = get_model(params, device=dev).eval()
    x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"forward wall {wall_ms:.1f} ms; device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of wall)")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=args.top))
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
