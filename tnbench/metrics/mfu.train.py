"""mfu.train: the model FLOPs of the sweeps of the traced sub-window (each
sweep's environment stack and its N - 1 steps' merge, gradient, split and
environment update, the same for every engine that runs the split), over the
sub-window's length times the peak, in %."""

from tnbench import roofline


def read(view):
    sweeps = view.counts.get("sweeps", 0)
    if not sweeps or view.window_s <= 0:
        return None
    cfg, tr = view.config, view.traffic
    flops = sweeps * roofline.sweep_flops(cfg["N"], cfg["M"], cfg["D"], cfg["L"], tr["batch"],
                                          tr["sweep"]["svd_method"])
    return 100.0 * flops / (view.window_s * roofline.PEAK_FLOPS)
