"""Milliseconds an iteration takes in the executor (``serving/executor.py``):
``RealTorchBackend.busy_seconds / iterations``, each iteration timed on the
host clock around work that ends in its device-to-host copy."""


def read(run):
    b = run.window.backend
    return b.busy_seconds / b.iterations * 1e3 if b.iterations else None
