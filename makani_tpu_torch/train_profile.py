"""Profiling training CLI (counterpart of makani_tpu/train_profile.py): the
train CLI with --profile 20 unless the command line sets --profile. The
torch.profiler trace of those steps lands in
<experiment dir>/profile/trace.json (Chrome trace format)."""

import sys

from makani_tpu_torch.train import main as train_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--profile") for a in argv):
        argv += ["--profile", "20"]
    return train_main(argv)


if __name__ == "__main__":
    main()
