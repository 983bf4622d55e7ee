"""Device milliseconds a decode step takes on the card: the operations
launched inside the ``repro_torch.executor.replay.decode`` spans of the
traced sub-window (each tied to the span through the runtime call that
launched it, by their correlation id), over those spans. Read from the
profile's ``program`` (``servebench.program``); None without it."""


def read(run):
    p = getattr(run.profile, "program", None)
    if p is None:
        return None
    spans, ops, seconds = p.replay["decode"]
    return seconds / spans * 1e3 if spans and ops else None
