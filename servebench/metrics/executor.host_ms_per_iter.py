"""Host milliseconds an iteration of the executor's work on the iteration's
critical path (``serving/executor.py``): the self time of the
``repro_torch.executor.`` ``prepare`` (the host inputs), ``upload``,
``replay.prefill`` / ``replay.decode`` (each step's launch), ``scatter``
(the sampled tokens written back) and ``iteration`` (the rest of
``run_plan``) spans in the traced sub-window, over its iterations. The wait
for the card's copy (``to_host``) is left out. Read from the profile's
``program`` (``servebench.program``); None without it."""

from servebench import program

PARTS = {program.PREFIX + "executor." + n for n in (
    "prepare", "upload", "replay.prefill", "replay.decode", "scatter",
    "iteration")}


def read(run):
    p = getattr(run.profile, "program", None)
    return program.per_iteration_ms(p, PARTS.__contains__) \
        if p is not None else None
