"""Device ms a step inside the optimizer's profiler range (the Trainer's
"train_step.optimizer"): the fused Adam update and what launches around it."""


def read(r, name):
    ms = sum(s for phase, s in r.trace.by_phase().items() if phase.endswith(".optimizer"))
    return 1e3 * ms / r.units if ms else None
