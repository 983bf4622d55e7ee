"""Host milliseconds an iteration outside the iteration itself: the
window's wall time less the wall time spent inside the scheduler's backend
calls (``run_iteration``), over the iterations. It is the scheduler's
event handling, dispatch and bookkeeping (``sched/core.py``,
``core/toggle.py``, ``core/policies.py``, ``sched/rebalance.py``) and the
harness's own loop (less its counting of each plan's kernel calls),
timed by the benchmark at the ``ExecutionBackend`` seam over the whole
window."""


def read(run):
    rec = run.window.recorder
    if not rec.iterations:
        return None
    return (run.window.wall_s - rec.iter_wall - rec.count_wall) \
        / rec.iterations * 1e3
