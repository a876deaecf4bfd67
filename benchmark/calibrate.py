"""The readings the check limits are set from, at a cell's own size, in one
process:

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e] [--seconds 2] [--out readings.jsonl]

For each of `--seeds`, one run of the program as the benchmark makes it
(set-up, a short window of `--seconds`, the output check), giving the
numbers compared: their largest over a dozen seeds or more is the lower
reading of each limit. For each of `--control-seeds`, the control: the
reference computed with its products in float8 e4m3, put in the program's
place (its first steps for a train cell; its forecast for a forecast
cell), checked against the float32 reference the same way: its smallest
is the upper reading. Each reading is a JSON line. The benchmark's own
runs never run the control.
"""

import argparse
import json
import random
import sys
import time

import torch

from benchmark.harness.spec import Spec, load_reference
from benchmark.harness.traffic import (adam_settings, field_pool, free_program, generator,
                                       strict_fp32, train_gaps)
from benchmark.reference.common import make_leaves


def control_train(params, mix, ref, seed, device):
    """The fp8 reference's checked steps against the float32 reference's."""
    lr, b1, b2, eps = adam_settings(params)
    spec = ref.parameters(params)
    pool = field_pool(params, mix, seed, device)
    batches = [(pool[i % len(pool)], pool[(i + 1) % len(pool)]) for i in range(mix["check_steps"])]
    readings = {}
    for precision in ("fp8", "float32"):
        model = ref.Model(params, device, precision)
        w = make_leaves(spec, generator(device, seed), device)
        readings[precision] = model.train_steps(w, batches, lr, b1, b2, eps)
        del model, w
        free_program(device)
    checks, worst = train_gaps(readings["fp8"], readings["float32"])
    return dict(checks, worst=worst)


def control_forecast(params, mix, ref, seed, device, steps):
    """The fp8 reference's forecast from the initial condition the check
    samples, each step against the float32 reference on its input."""
    spec = ref.parameters(params)
    pool = field_pool(params, mix, seed, device)
    sampled = random.Random(int(seed)).randrange(mix["sample_within"])
    w = make_leaves(spec, generator(device, seed), device)
    low, exact = ref.Model(params, device, "fp8"), ref.Model(params, device, "float32")
    gaps, x = [], pool[sampled % len(pool)]
    with torch.no_grad():
        for _ in range(steps):
            p, r = low.forward(w, x), exact.forward(w, x)
            gaps.append(float((p - r).norm() / r.norm()))
            x = p
    return {"step_gap": max(gaps), "step_gaps": gaps}


def main(argv=None):
    from benchmark.run import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    entry = spec.cell(args.workload)
    config = spec.config(entry["config"])
    params, mix = config["params"], spec.traffic(entry["traffic"])
    ref = load_reference(config["reference"])
    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    dev = torch.device("cuda")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        r = run_cell(spec, args.workload, seed, args.seconds, False, "cuda", worst=True)
        emit({"kind": "program", "workload": args.workload, "seed": seed,
              "checks": {k: c["value"] for k, c in r["checks"].items()}, "worst": r["worst"],
              "correct": r["correct"], "metrics": r["metrics"], "s": time.perf_counter() - t})
        free_program(dev)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        strict_fp32()
        if mix["kind"] == "train":
            checks = control_train(params, mix, ref, seed, dev)
        else:
            checks = control_forecast(params, mix, ref, seed, dev,
                                      int(params["valid_autoreg_steps"]) + 1)
        emit({"kind": "control", "workload": args.workload, "seed": seed, "checks": checks,
              "s": time.perf_counter() - t})
        free_program(dev)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
