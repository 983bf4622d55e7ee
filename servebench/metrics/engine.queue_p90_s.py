"""P90 of the seconds requests queued before their prefill started, on the
scheduler's clock: ``Worker.queue_times`` of every worker
(``serving/engine.py``), over the whole window."""

from servebench.stats import percentile


def read(run):
    waits = [t for w in run.window.workers.values()
             for t in w.queue_times.values()]
    return percentile(waits, 90) if waits else None
