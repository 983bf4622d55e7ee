"""Mean seconds a decoding request was blocked behind prefill work (the
paper's second root cause): ``Worker.blocked_time`` of every worker
(``serving/engine.py``), averaged over the requests it holds, as the port's
``ServeMetrics.blocked_time_avg``; 0 when no decode was blocked."""


def read(run):
    blocked = [t for w in run.window.workers.values()
               for t in w.blocked_time.values()]
    return sum(blocked) / len(blocked) if blocked else 0.0
