"""idle_share.train: the share of the traced sub-window of training in which
no kernel or copy ran on the card, in %."""

from tnbench.trace import idle_pct


def read(view):
    return idle_pct(view)
