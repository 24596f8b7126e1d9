"""k3_roofline: K3, the chain kernel (``ops/kernels/env_scan.py`` ->
``csrc/env_scan.cu``), as a share of its roofline in %: the least time for
the chain of N - 1 sites over one request's batch, over K3's mean profiled
time per launch."""

from tnbench import roofline

PATTERN = r"\bchain_kernel\b"


def read(view):
    launches = view.matching(PATTERN)
    if not launches:
        return None
    per_launch_s = sum(b - a for _, _, a, b in launches) / 1e6 / len(launches)
    cfg = view.config
    work = roofline.chain_work(cfg["N"] - 1, cfg["M"], view.traffic["batch_size"])
    return roofline.share_pct(work, per_launch_s)
