"""The device's idle share, read as `device_idle_share.mixed` reads it, in the
vector-only cell, which reports `search_qps.vectors`."""

from benchmark import harness

_SAME = harness.metric_reader("device_idle_share.mixed")
UNIT = _SAME.UNIT
read = _SAME.read
