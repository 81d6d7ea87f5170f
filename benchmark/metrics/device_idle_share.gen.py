"""Share of the profiled stretch of a generation window in which no
operation ran on the device."""

UNIT = "%"


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.device_ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
