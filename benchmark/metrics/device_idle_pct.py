"""The share of the traced window in which no kernel, copy or set ran on
the device, in percent."""


def read(r, name):
    if not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
