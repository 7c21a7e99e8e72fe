"""RS encode in repair: least time of one extension and one quadrant decode
per repair over the RS kernels' device time."""

from dabench.readers import roofline_pct
from dabench.roofline import rs_least_s


def read(view):
    return roofline_pct(view, "RS encode", rs_least_s(view.k, view.m, extensions=1, decodes=1))
