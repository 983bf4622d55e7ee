"""The whole step's share of the card's peak, in %: the model FLOPs of the
iterations in the traced sub-window (their ``step`` entries, counted by
the configuration's architecture, ``servebench/archs/<arch>.py``; for
``llama``: 2 x the parameters a token multiplies by, the routed experts
only for a MoE, plus attention over its causal context, plus the
unembedding of each token that yields one) over the seconds the card was
busy in it (the union of its operations' intervals in the device trace)
at 989 TFLOP/s. Padding, idle decode rows and the experts the routes do
not pick are not counted; the time the card stands idle is
``device.idle_share``'s."""

from servebench import cost


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    flops = sum(f for kind, f, _ in p.calls if kind == "step")
    return flops / (p.busy_s * cost.PEAK_FLOPS) * 100.0 if flops > 0 \
        else None
