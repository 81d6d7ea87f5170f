"""The batch's share of the chip's peak, read as `search_mfu` reads it, in the
vector-only cell, which reports `search_qps.vectors`."""

from benchmark import harness

_SAME = harness.metric_reader("search_mfu")
UNIT = _SAME.UNIT
read = _SAME.read
