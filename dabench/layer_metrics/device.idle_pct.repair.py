"""Device idle share of a repair window: 100 - merged device-busy time over the traced window."""

from dabench.readers import idle_pct


def read(view):
    return idle_pct(view)
