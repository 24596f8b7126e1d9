"""k6_roofline: K6, the rangefinder split (``ops/kernels/split_kernel.py`` ->
``csrc/rangefinder_split.cu``, four launches a call), as a share of its
roofline in %: the least time for the split of one step's two-site matrix,
over the summed device time of one call's launches."""

from tnbench import roofline

PATTERN = r"\b(sketch_tile_kernel|rf_finish_kernel|rf_cluster_kernel|rf_r_kernel)\b"
CALL = r"\brf_cluster_kernel\b"  # one a call


def read(view):
    launches = view.matching(PATTERN)
    calls = len(view.matching(CALL))
    if not launches or not calls:
        return None
    per_call_s = sum(b - a for _, _, a, b in launches) / 1e6 / calls
    cfg = view.config
    M, D, L = cfg["M"], cfg["D"], cfg["L"]
    I, J = M * D, L * D * M
    work = roofline.rf_work(I, J, min(M + roofline.RF_OVERSAMPLE, I), M)
    return roofline.share_pct(work, per_call_s)
