"""Share of the prompt tokens prefilled in the window that rode on an
iteration which also decoded (Tropical's multiplexing at work):
``RealTorchBackend.ridden_prefill_tokens / prefill_tokens``
(``serving/executor.py``), over the whole window; None when no prefill ran
or the backend does not count them."""


def read(run):
    b = run.window.backend
    total = getattr(b, "prefill_tokens", 0)
    return b.ridden_prefill_tokens / total if total else None
