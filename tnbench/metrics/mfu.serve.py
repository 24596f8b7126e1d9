"""mfu.serve: the model FLOPs of every sample scored in the traced
sub-window (label closure and chain), over the sub-window's length times the
peak, in %."""

from tnbench import roofline


def read(view):
    samples = view.counts.get("samples", 0)
    if not samples or view.window_s <= 0:
        return None
    cfg = view.config
    flops = samples * roofline.sample_flops(cfg["N"], cfg["M"], cfg["D"], cfg["L"])
    return 100.0 * flops / (view.window_s * roofline.PEAK_FLOPS)
