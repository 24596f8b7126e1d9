"""k2_roofline: K2, the pre-split step (``ops/kernels/presplit_kernel.py`` ->
``csrc/presplit.cu``, six launches a call), as a share of its roofline in %:
the least time for one step's merge, gradient, output, sketch and Gram, over
the summed device time of one call's launches."""

from tnbench import roofline

PATTERN = r"presplit::(prep|gradient|update|transpose|products|finish)_kernel\b"
CALL = r"presplit::finish_kernel\b"  # one a call


def read(view):
    launches = view.matching(PATTERN)
    calls = len(view.matching(CALL))
    if not launches or not calls:
        return None
    per_call_s = sum(b - a for _, _, a, b in launches) / 1e6 / calls
    cfg = view.config
    M, D, L = cfg["M"], cfg["D"], cfg["L"]
    work = roofline.presplit_work(L, M * D, M, D * M, view.traffic["batch"], M, D)
    return roofline.share_pct(work, per_call_s)
