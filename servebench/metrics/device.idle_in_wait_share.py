"""Share of the card's idle time in the traced sub-window during which the
host was in ``repro_torch.executor.to_host``: the card done, the host not
back from its wait yet.

The idle time is that of the gaps between the card's operations
(``servebench.program``): each gap of 10 us or more split by overlap
over its whole length among the innermost spans the host was in; the
shorter gaps, the rest of the whole, are summed apart. With the other
three such shares and the short gaps' share, it sums to 1. Read from the
profile's ``program``; None without it, or without any span of the
program."""

from servebench import program


def read(run):
    p = getattr(run.profile, "program", None)
    return program.idle_share(p, "wait") if p is not None else None
