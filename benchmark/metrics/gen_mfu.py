"""The model's share of the chip's bf16 peak over the window: the
operations of every token delivered in it and of every prompt first
answered in it (projections, attention's products, the output head),
counted from the configuration's shapes, over the window's seconds."""

from benchmark import roofline

UNIT = "%"


def read(r):
    w = r.work
    if not w.get("model_flops") or not w.get("window_s"):
        return None
    return 100.0 * w["model_flops"] / (w["window_s"]
                                       * roofline.PEAK_BF16_FLOPS)
