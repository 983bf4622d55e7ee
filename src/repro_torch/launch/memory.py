"""The high-water mark of one rank's live local bytes during a step.

``LiveBytes`` is the dry-run's count of transient memory: the counterpart
of XLA's ``temp_size_in_bytes``, which the JAX dry-run reads from the
compiled module's buffer assignment. It is the port's own count of live
buffers, not XLA-CPU's assignment (which also holds f32 upcasts of bf16
dot operands that neither a TPU nor the card makes).

``hloanalysis.StepCost(memory=LiveBytes(...))`` hands it every local op of
one rank (``LocalOps``: on local shapes, with every redistribution and
collective of DTensor's or of a ``local_map`` region as a plain op, and
the ops of the backward pass and of a remat's recomputation too):

* a storage that an op returns and that no op of the step had read or
  returned before is a new buffer. It counts from that op until the
  storage dies: a ``weakref.finalize`` on the storage fires when its last
  tensor or view is gone (the storage's Python object lives as long as
  the storage itself). Activations, the outputs of the collectives (of
  the fake group's too, which allocate their results and move nothing),
  a gathered cache, MoE dispatch buffers, the tensors autograd saves for
  the backward, the gradients and the optimizer's temporaries are all
  such buffers;
* views, in-place writes and ``out=`` ops return a storage already known
  and allocate nothing (the donated cache's in-place row writes); so does
  a functional collective's ``_wrap_tensor_autograd``, whose meta kernel
  allocates a copy where the device's wraps its input: the input's bytes
  stay live while the wrapper does;
* a storage an op reads that was never seen before (the step's arguments,
  or a tensor made outside any op, such as ``torch.tensor(data)``) is
  taken as already there and is not counted.

It does not see what an op allocates and frees inside itself (a library's
workspace, cuBLAS's included, or a sort's temporaries), the caching
allocator's rounding (512-byte blocks on the card) or its fragmentation,
nor a storage that grows in place (``resize_``), which keeps the size it
was first seen with. On meta tensors a kernel op returns its output only,
as the card's kernels allocate only theirs; on the CPU the kernel ops run
their plain versions, whose intermediates are ops and are counted.

``peak`` is the high-water mark of the bytes allocated during the step;
``peak_at`` the op that set it, the layer whose weights the rank's ops
read last (a leaf of a ``*blocks`` stack of ``params``, ``blocks[i]``;
None after an op that read a whole stack, as the optimizer does), and
whether the autograd engine was running a backward pass.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.hloanalysis import _tensors


def _counted(t) -> bool:
    """A plain strided tensor: not a wrapper (a DTensor, the fake tensors
    of DTensor's propagation, a functional collective's
    ``AsyncCollectiveTensor``, whose data is its wrapped result's)."""
    return type(t) in (torch.Tensor, torch.nn.Parameter) \
        and t.layout == torch.strided


# ops whose output is their input's data on a device, where their meta
# kernel allocates a new tensor: the output is counted as the input's
# storage, which lives on until both are gone (on the card the wrapper
# holds the collective's result)
_ALIASES = ("_c10d_functional::_wrap_tensor_autograd",)


def _in_backward() -> bool:
    task = getattr(torch._C, "_current_graph_task_id", None)
    return task is not None and task() != -1


class LiveBytes:
    """Live local bytes allocated during a step, and their high-water mark.
    ``params`` (a tree of tensors or DTensors, optional) names the layers
    of ``peak_at``: each leaf under a key ending in ``blocks`` is a stack
    whose first dim is the layer."""

    def __init__(self, params=None):
        self.live = 0
        self.peak = 0
        self.layer = None
        self._peak_at = None
        self._known = WeakIdKeyDictionary()   # storages there before
        self._mine = WeakIdKeyDictionary()    # storages allocated here
        self._stacks = WeakIdKeyDictionary()  # storage -> its stack's shape
        self._holds = WeakIdKeyDictionary()   # alias -> the storage it is
        if params is not None:
            self._watch(params, "")

    def _watch(self, tree, path: str) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                self._watch(v, k if path == "" else path)
            return
        if not isinstance(tree, torch.Tensor) or not path.endswith("blocks"):
            return
        local = getattr(tree, "_local_tensor", tree)
        if local.dim() >= 1 and local.shape[0] > 0 and local.stride(0) > 0:
            self._stacks[local.untyped_storage()] = (
                path, local.shape[0], local.numel(), local.storage_offset(),
                local.stride(0))

    def _name_layer(self, t, stack) -> None:
        name, n, numel, offset, stride = stack
        if t.numel() * n > numel:
            self.layer = None   # the whole stack: no one layer's op
            return
        i = (t.storage_offset() - offset) // stride
        if 0 <= i < n:
            self.layer = f"{name}[{i}]"

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def op(self, func, args, kwargs, out) -> None:
        """One local op: mark what it read, count what it allocated."""
        for t in _tensors(list(args)) + _tensors(list(kwargs.values())):
            if not _counted(t):
                continue
            s = t.untyped_storage()
            if s not in self._mine and s not in self._known:
                self._known[s] = True
            stack = self._stacks.get(s)
            if stack is not None:
                self._name_layer(t, stack)
        alias = func._schema.name in _ALIASES
        for t in _tensors(out):
            if not _counted(t):
                continue
            s = t.untyped_storage()
            if s in self._mine or s in self._known:
                continue
            if alias:
                self._known[s] = True
                self._holds[s] = args[0].untyped_storage()
                continue
            n = s.nbytes()
            self._mine[s] = True
            weakref.finalize(s, self._free, n)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
                self._peak_at = (func, self.layer, _in_backward())

    @property
    def peak_at(self) -> dict:
        """{"op", "layer", "backward"} where the high-water mark fell."""
        if self._peak_at is None:
            return {"op": None, "layer": None, "backward": False}
        func, layer, backward = self._peak_at
        return {"op": str(func), "layer": layer, "backward": backward}
