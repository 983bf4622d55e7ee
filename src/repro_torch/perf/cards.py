"""Specs of the cards the port runs on, in ``HardwareSpec``'s units.

``H100``: the NVIDIA H100 SXM5 80 GB data sheet. bf16 dense tensor-core
peak 989 TFLOP/s, HBM3 3.35 TB/s and 80 GB; NVLink 4 as 18 links of
50 GB/s both ways (900 GB/s), so 25 GB/s per link and direction; PCIe Gen5
x16 to the host, 64 GB/s each way. The efficiency fractions, ``t_fixed``
and ``interference`` stay at ``HardwareSpec``'s assumed defaults, as
``V5E``'s do: ``perf.calibrate.calibrate_hardware(H100)`` measures them on
the card at run time. ``t_fixed`` keeps the assumed 3 ms although the host
term of a graphed step (wall minus device time) is measured: it is of the
same order (PERF.md), and a new price changes admission and chunk sizes,
which only a benchmark's SLO attainment can judge (ROADMAP.md, queue 3).
"""
from __future__ import annotations

from repro_torch.perf.hardware import HardwareSpec

H100 = HardwareSpec(
    name="h100-sxm5",
    peak_flops=989e12,          # bf16 dense, per card
    hbm_bw=3.35e12,             # bytes/s
    hbm_bytes=80e9,
    ici_bw=25e9,                # NVLink 4: bytes/s per link and direction
    ici_links=18,
    host_bw=64e9,               # PCIe Gen5 x16, bytes/s each direction
)
