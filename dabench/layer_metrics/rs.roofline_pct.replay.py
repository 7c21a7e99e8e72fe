"""RS encode: least time of one extension per square (dabench/roofline.py)
over the RS kernels' device time."""

from dabench.readers import roofline_pct
from dabench.roofline import rs_least_s


def read(view):
    return roofline_pct(view, "RS encode", rs_least_s(view.k, view.m, extensions=1))
