"""RS kernel launches per repair: the program's launch counters over the window."""

from dabench.readers import launches_per_op


def read(view):
    return launches_per_op(view, "RS encode")
