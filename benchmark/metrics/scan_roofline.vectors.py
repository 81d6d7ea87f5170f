"""The scans' share of their roofline, read as `scan_roofline` reads it, in the
vector-only cell, which reports `search_qps.vectors`."""

from benchmark import harness

_SAME = harness.metric_reader("scan_roofline")
UNIT = _SAME.UNIT
read = _SAME.read
