"""The paged-decode kernel's share of its roofline, in %
(``kernels/paged_attention.py``, ``csrc/paged_attention.cu``): the bound
time of the calls made in the traced sub-window (each call's bytes at
3.35 TB/s or its operations at 989 TFLOP/s, whichever is longer, counted
from the plans by the architecture's ``count``, its ``decode`` calls)
over the device time of the kernels named ``paged_attention`` there."""

from servebench.metrics import roofline


def read(run):
    return roofline(run, "decode", "paged_attention")
