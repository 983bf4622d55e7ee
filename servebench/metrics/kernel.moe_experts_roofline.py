"""The held experts' products' share of their roofline, in %, over the
whole window: for each step and MoE layer, the least time the routed work
that happened could take (``servebench/cost.py``'s ``bound_s``): its
operations, 6 x d_model x d_ff for each token-expert assignment to a held
expert, at 989 TFLOP/s, or its bytes, the weights of each held expert
that some assignment went to (3 x d_model x d_ff each) and each
assignment's token in and out (d_model each way), at 3.35 TB/s, whichever
is longer; summed, over the card time the products took
(``RealTorchBackend.moe_expert_seconds``). The counts are the program's
(``RealTorchBackend.moe_counts``: a row a step and layer, held
assignments and held experts touched over the step's live tokens), never
an expectation, and never the held tables whole. None where the program
counts or times nothing."""

from servebench import cost


def read(run):
    b = run.window.backend
    spent = getattr(b, "moe_expert_seconds", 0.0)
    steps = getattr(b, "moe_counts", None)
    if not steps or spent <= 0:
        return None
    s = run.shape
    expert_bytes = 3.0 * s.d_model * s.d_ff * s.dtype_bytes
    bound = 0.0
    for counts in steps:
        for held, touched, _ in counts:
            token_bytes = 2.0 * held * s.d_model * s.dtype_bytes
            bound += cost.bound_s(6.0 * held * s.d_model * s.d_ff,
                                  touched * expert_bytes + token_bytes)
    return bound / spent * 100.0
