"""NMT: least time of the 4k trees per square (dabench/roofline.py) over the
SHA-256 kernels' device time."""

from dabench.readers import roofline_pct
from dabench.roofline import nmt_least_s


def read(view):
    return roofline_pct(view, "NMT", nmt_least_s(view.k))
