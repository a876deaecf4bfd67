"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit), and the least time a piece of work can take on it: a
frozen copy of the program's `bound` (chip_smoke.py)."""

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes, flops, rate=BF16_FLOPS):
    """max(bytes / HBM bandwidth, operations / peak rate), in seconds."""
    return max(nbytes / HBM_BPS, flops / rate)
