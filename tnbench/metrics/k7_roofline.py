"""k7_roofline: K7, the fused engine's two-site step (``ops/kernels/
step_kernel.py::two_site_sweep`` -> ``csrc/two_site_step.cu``: K2's six
stages, K1's cluster and ``step_env_kernel`` a step), as a share of its
roofline in %: the least time for one step's pre-split, polar iteration,
Q^T bn and left Q, over the device time of one step.

K7's launches are programmatic dependent launches: each starts while the
one before it runs and waits in its first statement, so a launch's profiled
span holds part of its predecessor's run, and the spans of one step add up
to more than the step. The step's time is therefore the union of all K7
launches' spans in the sub-window, which counts each instant once, over the
number of steps (one ``step_env_kernel`` a step)."""

from tnbench import roofline
from tnbench.trace import union_us

PATTERN = (r"presplit::(prep|gradient|update|transpose|products|finish)_kernel\b"
           r"|\bpolar_(cluster|streaming)_kernel\b|\bstep_(env|store)_kernel\b")
STEP = r"\bstep_env_kernel\b"  # one a step


def read(view):
    launches = view.matching(PATTERN)
    steps = len(view.matching(STEP))
    if not launches or not steps:
        return None
    per_step_s = union_us([(a, b) for _, _, a, b in launches]) / 1e6 / steps
    cfg = view.config
    work = roofline.step_work(cfg["L"], cfg["M"], view.traffic["batch"], cfg["D"])
    return roofline.share_pct(work, per_step_s)
