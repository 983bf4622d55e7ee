"""Host milliseconds an iteration of the scheduler's own work, timed inside
the program: the self time (less their child spans) of the
``repro_torch.sched.*`` spans (``serving/simulator.py``'s event loop,
``sched/core.py``'s event handlers and each iteration's decision) in the
traced sub-window, over its ``repro_torch.executor.iteration`` spans. The
twin of ``sched.host_ms_per_iter`` without the harness: its loop lies
outside every span, and the backend call's own wrapping
(``repro_torch.sched.backend`` less the executor's iteration: the
benchmark's recorder and its counting) is left out. Read from the
profile's ``program`` (``servebench.program``), which
``servebench/attribute.py`` attaches; None without it."""

from servebench import program


def read(run):
    p = getattr(run.profile, "program", None)
    if p is None:
        return None
    return program.per_iteration_ms(
        p, lambda name: program.category(name) == "sched")
