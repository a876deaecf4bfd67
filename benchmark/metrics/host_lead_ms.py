"""The median host lead of the run's units, ms: how long the card took to
reach a train step (".train") or a forecast step (".serve") after the host
enqueued its start, from the program's own counter
(makani_tpu_torch/utils/tracing.leads), over every unit of the run, the
untraced window's included. Near 0 the host sets the pace; near a unit's
time or more the card does. Nothing where the program keeps no such
counter."""

import statistics


def read(r, name):
    try:
        from makani_tpu_torch.utils import tracing
    except ImportError:
        return None
    leads = tracing.leads(name.split(".")[1])
    return statistics.median(leads) if leads else None
