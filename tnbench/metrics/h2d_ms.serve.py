"""h2d_ms.serve: device time of the host-to-device copies per request, in ms
(the profiler's memcpy events), over the traced sub-window's requests."""

import re

PATTERN = re.compile(r"Memcpy HtoD|HtoD")


def read(view):
    requests = view.counts.get("requests", 0)
    copies = [e for e in view.device if e[1] == "gpu_memcpy" and PATTERN.search(e[0])]
    if not requests or not copies:
        return None
    return sum(b - a for _, _, a, b in copies) / 1e3 / requests
