"""The chunked-prefill kernel's share of its roofline, in %
(``kernels/chunked_prefill.py``, ``csrc/chunked_prefill.cu``): as
``kernel.paged_attention_roofline``, for the prefill calls and the kernels
named ``chunked_prefill``."""

from servebench.metrics import roofline


def read(run):
    return roofline(run, "prefill", "chunked_prefill")
