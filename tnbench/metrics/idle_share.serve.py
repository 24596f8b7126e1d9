"""idle_share.serve: the share of the traced sub-window of serving in which
no kernel or copy ran on the card, in %."""

from tnbench.trace import idle_pct


def read(view):
    return idle_pct(view)
