"""Device ms a unit of copies from the device to the host (the profiler's
DtoH memcpy events): the forecast's predictions reaching page-locked
memory."""


def read(r, name):
    s = r.trace.by_category().get("d2h", 0.0)
    return 1e3 * s / r.units if s else None
