"""k1_roofline: K1, the polar iteration (``ops/kernels/polar_split.py::
polar_iterate`` -> ``csrc/polar_iterate.cu``), as a share of its roofline in
%: the least time for the split's fixed pass schedule at I = M D, q = M,
over K1's mean profiled time per launch."""

from tnbench import roofline

PATTERN = r"\bpolar_(cluster|streaming)_kernel\b"


def read(view):
    launches = view.matching(PATTERN)
    if not launches:
        return None
    per_launch_s = sum(b - a for _, _, a, b in launches) / 1e6 / len(launches)
    cfg = view.config
    return roofline.share_pct(roofline.polar_work(cfg["M"] * cfg["D"], cfg["M"]), per_launch_s)
