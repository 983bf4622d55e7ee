"""A step's cost without HLO: dot FLOPs, collective bytes and the
three-term roofline, counted over one rank's traced ops.

Counterpart of ``repro/launch/hloanalysis.py``. The JAX module parses the
compiled, partitioned HLO text of one device; here ``StepCost``, a
``TorchDispatchMode``, counts the ops that one rank runs while the step
executes, on real tensors or on meta ones (``launch.dryrun``):

* matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``: what ``matmul``, ``einsum`` and ``linear`` lower to): 2·M·N·K
  FLOPs, and the bytes of the operands and the result, the counterpart of
  ``_body_dot_flops``;
* the kernel ops of ``kernels.ops`` (attention, WKV6), which report their
  own dense count (``kernels.cost``, whose listener ``StepCost`` is while
  it is on) because a kernel launch is not a dispatcher op;
* every collective, from ``_c10d_functional`` (DTensor's redistributions,
  ``local_map`` regions) and ``c10d`` (the EP path's ``torch.distributed``
  calls), with ``collective_record``'s operand and wire bytes.

The counts are per rank, on local shapes. A mode sees an op on DTensors
first, with global shapes; ``StepCost`` hands it back to DTensor (returning
``NotImplemented`` from a nested call) with itself still on the stack, so
that the local op DTensor runs, and any redistribution it issues, reach the
mode as plain tensors. Ops on ``FakeTensor``s are DTensor's own sharding
propagation and are not counted.

``scan_correction`` and ``_block_multipliers`` have no counterpart: the
port's layer and chunk loops are Python loops, so every iteration is traced
and counted once; there is no loop body whose count needs multiplying.
The HLO text parse itself (``collective_bytes``' line parsing,
``module_cost`` over text) has none either; ``collective_record`` keeps its
accounting.

``roofline`` prices a step on ``perf.cards.H100`` unless given other peaks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import cost as kernel_cost

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_record(kind: str, result_bytes: int, n: int) -> tuple:
    """(operand bytes, wire bytes) of one collective over a group of ``n``
    whose result is ``result_bytes``, by the formulas of the JAX
    ``collective_bytes``: ring factor (n - 1) / n; all-gather's operand is
    its result over n, reduce-scatter's n times it; all-reduce moves twice
    the ring's share; a permute moves its operand."""
    ring = (n - 1) / n if n > 1 else 0.0
    if kind == "all-gather":
        return result_bytes // max(n, 1), int(result_bytes * ring)
    if kind == "reduce-scatter":
        operand = result_bytes * n
        return operand, int(operand * ring)
    if kind == "all-reduce":
        return result_bytes, int(2 * result_bytes * ring)
    if kind == "all-to-all":
        return result_bytes, int(result_bytes * ring)
    if kind == "collective-permute":
        return result_bytes, result_bytes
    raise ValueError(f"collective_record: unknown kind {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(group) -> int:
    """The size of a functional collective's group (its name) or of a
    ``c10d`` op's process group (a boxed ``ScriptObject``)."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group).size()
    from torch._C._distributed_c10d import ProcessGroup
    return ProcessGroup.unbox(group).size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


# (namespace, op name) -> (kind, reader of (result bytes, group size, the
# input tensors) from the op's args and output)
def _functional(kind, result):
    def read(args, out):
        return result(args, out), _group_size(args[-1]), _tensors(args[0])
    return kind, read


def _c10d(kind, pg_index, inputs_index, result):
    def read(args, out):
        return (result(args), _group_size(args[pg_index]),
                _tensors(args[inputs_index]))
    return kind, read


def _sum_bytes(x) -> int:
    return sum(_nbytes(t) for t in _tensors(x))


_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"):
        _functional("all-reduce", lambda a, o: _sum_bytes(a[0])),
    ("_c10d_functional", "all_reduce_"):
        _functional("all-reduce", lambda a, o: _sum_bytes(a[0])),
    ("_c10d_functional", "all_reduce_coalesced"):
        _functional("all-reduce", lambda a, o: _sum_bytes(a[0])),
    ("_c10d_functional", "all_gather_into_tensor"):
        _functional("all-gather", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional", "all_gather_into_tensor_out"):
        _functional("all-gather", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        _functional("all-gather", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional", "reduce_scatter_tensor"):
        _functional("reduce-scatter", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        _functional("reduce-scatter", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional", "all_to_all_single"):
        _functional("all-to-all", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional_autograd", "all_gather_into_tensor"):
        _functional("all-gather", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional_autograd", "reduce_scatter_tensor"):
        _functional("reduce-scatter", lambda a, o: _sum_bytes(o)),
    ("_c10d_functional_autograd", "all_to_all_single"):
        _functional("all-to-all", lambda a, o: _sum_bytes(o)),
    # c10d's in-place ops: (tensors, process group, ...) and friends
    ("c10d", "allreduce_"):
        _c10d("all-reduce", 1, 0, lambda a: _sum_bytes(a[0])),
    ("c10d", "allgather_"):
        _c10d("all-gather", 2, 1, lambda a: _sum_bytes(a[0])),
    ("c10d", "_allgather_base_"):
        _c10d("all-gather", 2, 1, lambda a: _sum_bytes(a[0])),
    ("c10d", "reduce_scatter_"):
        _c10d("reduce-scatter", 2, 1, lambda a: _sum_bytes(a[0])),
    ("c10d", "_reduce_scatter_base_"):
        _c10d("reduce-scatter", 2, 1, lambda a: _sum_bytes(a[0])),
    ("c10d", "alltoall_base_"):
        _c10d("all-to-all", 2, 1, lambda a: _sum_bytes(a[0])),
    ("c10d", "alltoall_"):
        _c10d("all-to-all", 2, 1, lambda a: _sum_bytes(a[0])),
}

_A = torch.ops.aten
_DOTS = {_A.mm.default, _A.addmm.default, _A.bmm.default,
         _A.baddbmm.default, _A.mv.default, _A.dot.default}
# ops whose output is (a view or a copy of) their first input's data: a
# parameter passed through them is still the parameter for ``param_*``
_MOVES = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
          "contiguous", "clone", "chunk", "split", "split_with_sizes",
          "narrow", "slice", "select", "expand", "_to_copy", "alias",
          "detach", "unbind", "unsqueeze", "squeeze", "as_strided",
          "_reshape_alias", "flatten", "unflatten", "movedim"}


def _dot_cost(func, args, out) -> tuple:
    """(FLOPs, operand + result bytes) of one matrix product."""
    if func in (_A.addmm.default, _A.baddbmm.default):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    k = a.shape[-1]
    flops = 2.0 * out.numel() * k
    return flops, float(_nbytes(a) + _nbytes(b) + _nbytes(out))


def _is_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in _tensors(list(args)))


class LocalOps(TorchDispatchMode):
    """A dispatch mode that sees one rank's local ops. A mode meets an op
    on DTensors first, with global shapes; this one hands it back to
    DTensor (returning ``NotImplemented`` from a nested call) with itself
    still on, so that the local op DTensor runs, and every redistribution
    it issues, reach ``local_op`` as plain tensors. ``dtensor_op`` sees
    the DTensor op's arguments and result afterwards."""

    def __init__(self):
        super().__init__()
        self._inner = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if self._inner:
                return NotImplemented
            self._inner = True
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._inner = False
            self.dtensor_op(func, args, out)
            return out
        return self.local_op(func, args, kwargs)

    def dtensor_op(self, func, args, out) -> None:
        pass

    def local_op(self, func, args, kwargs):
        return func(*args, **kwargs)


class StepCost(LocalOps):
    """Counts one rank's dot FLOPs and bytes and its collectives while on.

        with StepCost(params=params) as cost:
            step(...)
        cost.result()      # module_cost's dict

    ``params`` (a tree of tensors or DTensors, optional): collectives whose
    input is one of these tensors' data (their local shards, or a view or
    copy of one) are also counted in ``param_counts`` / ``param_bytes``,
    by kind: a weight gathered whole shows there. ``memory`` (a
    ``launch.memory.LiveBytes``, optional) is handed every local op, to
    count the rank's live bytes."""

    def __init__(self, params=None, memory=None):
        super().__init__()
        self.memory = memory
        self.flops = 0.0
        self.bytes = 0.0
        self.op_flops = {}       # the kernel ops' own counts, by op name
        self.kernel_calls = []   # (op, q shape, K/V shape, q dtype, K/V dtype)
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.wire = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.param_counts = {k: 0 for k in COLLECTIVES}
        self.param_bytes = {k: 0.0 for k in COLLECTIVES}
        self.records = []        # (kind, operand bytes, group size, namespace)
        self.seen = WeakIdKeyDictionary()   # every local tensor an op read
        self._params = WeakIdKeyDictionary()
        if params is not None:
            self.watch(params)

    def watch(self, tree) -> None:
        """Mark the tensors of ``tree`` (their local shards) as
        parameters."""
        if isinstance(tree, dict):
            for v in tree.values():
                self.watch(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                self.watch(v)
        elif isinstance(tree, torch.Tensor):
            local = getattr(tree, "_local_tensor", tree)
            self._params[local] = True
            self._params[tree] = True

    def __enter__(self):
        kernel_cost.LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.LISTENERS.remove(self)
        return super().__exit__(*exc)

    def add_op(self, name: str, flops: float, nbytes: float,
               shapes: tuple = ()) -> None:
        """A kernel op's own count (``kernels.cost``), and the local shapes
        and dtypes it was called with (``kernel_calls``)."""
        self.flops += flops
        self.bytes += nbytes
        self.op_flops[name] = self.op_flops.get(name, 0.0) + flops
        self.kernel_calls.append((name,) + tuple(shapes))

    def dtensor_op(self, func, args, out) -> None:
        self._taint(func, args, out)

    def local_op(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if _is_fake(args):
            return out
        if self.memory is not None:
            self.memory.op(func, args, kwargs, out)
        for t in _tensors(list(args)) + _tensors(list(kwargs.values())):
            self.seen[t] = True
        if func in _DOTS:
            f, b = _dot_cost(func, args, out)
            self.flops += f
            self.bytes += b
            return out
        key = (func.namespace, func._schema.name.split("::")[-1])
        rec = _COLLECTIVE_OPS.get(key)
        if rec is not None:
            kind, read = rec
            result_b, n, inputs = read(args, out)
            operand, wire = collective_record(kind, result_b, n)
            self.coll[kind] += operand
            self.wire[kind] += wire
            self.counts[kind] += 1
            self.records.append((kind, operand, n, func.namespace))
            if any(t in self._params for t in inputs):
                self.param_counts[kind] += 1
                self.param_bytes[kind] += operand
            return out
        self._taint(func, args, out)
        return out

    def _taint(self, func, args, out) -> None:
        if not len(self._params):
            return
        name = func._schema.name.split("::")[-1]
        if name not in _MOVES:
            return
        src = args[0] if args else None
        if isinstance(src, torch.Tensor) and src in self._params:
            for t in _tensors(out):
                self._params[t] = True
                local = getattr(t, "_local_tensor", None)
                if local is not None:
                    self._params[local] = True

    def result(self) -> dict:
        """The JAX ``module_cost``'s dict: flops, bytes, collectives (each
        kind's operand bytes, total, wire, wire_total, counts) and
        ``n_multiplied_blocks`` (0: nothing is multiplied here)."""
        out = dict(self.coll)
        out["total"] = sum(self.coll.values())
        out["wire"] = dict(self.wire)
        out["wire_total"] = sum(self.wire.values())
        out["counts"] = dict(self.counts)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": out, "n_multiplied_blocks": 0}


# ------------------------------------------------------------------ roofline


def h100_peaks() -> tuple:
    """(FLOP/s, HBM bytes/s, link bytes/s) of ``perf.cards.H100``. The link
    term takes the card's whole NVLink rate in one direction (18 links of
    25 GB/s: 450 GB/s), where the JAX roofline takes one ICI link: an H100
    reaches every other card of its NVSwitch domain over all of its links
    at once, so a ring step's per-device bytes leave at that rate. A mesh
    axis that crosses hosts would go over the network instead, which this
    term does not model."""
    from repro_torch.perf.cards import H100
    return (H100.peak_flops, H100.hbm_bw, H100.ici_bw * H100.ici_links)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float              # per device (dot flops)
    hlo_bytes: float              # per device
    coll_bytes: float             # per device
    model_flops_per_device: float
    useful_ratio: float           # model_flops / hlo_flops
    peak_flops: float = 0.0       # the peak the compute term divided by

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful compute time / modeled step time, on the same peak the
        terms were priced with."""
        if self.step_s <= 0 or self.peak_flops <= 0:
            return 0.0
        return self.model_flops_per_device / self.peak_flops / self.step_s

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(dot: dict, resident_bytes: float, coll: dict,
             model_flops_total: float, n_devices: int,
             peaks: Optional[tuple] = None) -> RooflineTerms:
    """Three-term roofline per device, as the JAX ``roofline``: compute =
    dot FLOPs / peak; memory = max(resident bytes, dot bytes) / HBM rate;
    collective = wire bytes / link rate. ``peaks`` = (FLOP/s, HBM bytes/s,
    link bytes/s), ``h100_peaks()`` by default."""
    peak, hbm, link = peaks if peaks is not None else h100_peaks()
    flops = float(dot["flops"])
    bytes_ = max(float(resident_bytes), float(dot["bytes"]))
    cb = float(coll.get("wire_total", coll.get("total", 0.0)))
    mf = model_flops_total / n_devices
    return RooflineTerms(
        compute_s=flops / peak,
        memory_s=bytes_ / hbm,
        collective_s=cb / link,
        hlo_flops=flops, hlo_bytes=bytes_, coll_bytes=cb,
        model_flops_per_device=mf,
        useful_ratio=mf / flops if flops > 0 else 0.0,
        peak_flops=peak,
    )


def model_flops(cfg, kind: str, batch: int, seq: int,
                dec_len: Optional[int] = None) -> float:
    """MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D (+attn) for
    inference, over the port's copy of ``perf.build_cost_spec``."""
    from repro_torch.perf import build_cost_spec
    spec = build_cost_spec(cfg)
    if kind == "train":
        d = dec_len if cfg.family == "encdec" and dec_len else seq
        tokens = batch * d
        base = 6.0 * spec.n_active * tokens
        if cfg.family == "encdec":
            enc_active = spec.n_params - spec.n_active
            base += 6.0 * enc_active * batch * seq
        attn = 3.0 * spec.attn_flops_per_ctx_token * (seq / 2) * tokens
        return base + attn
    if kind == "prefill":
        tokens = batch * seq
        base = 2.0 * spec.n_active * tokens
        if cfg.family == "encdec":
            enc_active = spec.n_params - spec.n_active
            base = 2.0 * enc_active * tokens \
                + 2.0 * spec.n_active * batch * (dec_len or 64)
        attn = spec.attn_flops_per_ctx_token * (seq / 2) * tokens
        return base + attn
    base = 2.0 * spec.n_active * batch
    attn = spec.attn_flops_per_ctx_token * seq * batch
    return base + attn
