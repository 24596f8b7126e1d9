"""mfu.ring: the model FLOPs of the ring's autodiff steps in the traced
sub-window (each step's forward and backward contractions,
``ring_work.step_flops``), over the sub-window's length times the peak, in
%."""

from tnbench import ring_work, roofline


def read(view):
    steps = view.counts.get("steps", 0)
    if not steps or view.window_s <= 0:
        return None
    cfg = view.config
    flops = steps * ring_work.step_flops(cfg["N"], cfg["M"], cfg["D"], cfg["L"],
                                         view.traffic["batch"])
    return 100.0 * flops / (view.window_s * roofline.PEAK_FLOPS)
