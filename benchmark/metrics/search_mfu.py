"""The whole batch's share of the chip's peak: the least time of the
scans' work (as `scan_roofline` counts it) over the batch's wall time,
all batches of the traced run's window together."""

from benchmark import roofline

UNIT = "%"


def read(r):
    w = r.work
    if not w.get("batches") or "rows" not in w:
        return None
    bound = roofline.scan_bound_s(w["queries"], w["rows"], w["dim"],
                                  w["prefix"]) * w["batches"]
    return 100.0 * bound / w["window_s"]
