"""Unified scheduling core.

One SLO-aware ``ClusterScheduler`` owns dispatch, the global queue,
iteration planning, decode routing and role lifecycle; clock/compute
sources (the discrete-event ``Simulator``, the real-JAX executor, the
trace-replay stream) drive it through the narrow ``ExecutionBackend``
protocol, so every execution substrate exercises the *same* scheduling
code path.
"""
from repro_torch.sched.backend import (CallableBackend, CostModelBackend,
                                 ExecutionBackend, TraceReplayBackend)
from repro_torch.sched.core import ClusterScheduler
from repro_torch.sched.rebalance import RebalanceConfig, RoleRebalancer

__all__ = [
    "CallableBackend",
    "ClusterScheduler",
    "CostModelBackend",
    "ExecutionBackend",
    "RebalanceConfig",
    "RoleRebalancer",
    "TraceReplayBackend",
]
