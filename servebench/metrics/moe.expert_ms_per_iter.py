"""Milliseconds an iteration spends in the held experts' products, on the
card's clock: ``RealTorchBackend.moe_expert_seconds / iterations``
(``serving/executor.py``), the summed elapsed times of the CUDA event
pair each captured step records around each MoE layer's expert products
(``models/moe.py``'s ``Probe``), over the whole window; None where no
pair was timed (no MoE layer, no card, or a program without the pairs)."""


def read(run):
    b = run.window.backend
    spent = getattr(b, "moe_expert_seconds", 0.0)
    return spent / b.iterations * 1e3 if spent > 0 and b.iterations \
        else None
