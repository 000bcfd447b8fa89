"""What DTensor lacks for the port's sharded steps.

- Sharding strategies for the aten ops the models reach that DTensor has
  none for, registered on import (``launch.steps`` imports this module).
  ``log_sigmoid_backward`` (the backward of ``F.logsigmoid``: the mLSTM
  and sLSTM gates) is elementwise, so every operand takes the output's
  layout; its ``buffer`` operand is the forward's scratch, empty off the
  CPU, and then replicated.
- ``replicating``, ``implicit_replication()`` for a backward that reruns
  model code on DTensors.
- ``AlignedLayouts``, a dispatch mode the sharded steps run under, which
  keeps each DTensor's global strides in its local shard's memory order,
  and replicates a view's operand where DTensor cannot split its sharded
  dim as the view asks.
- ``collective_source``, which names the code that issues a collective,
  so that ``roofline.analysis.StepRecorder`` files the port's own
  reshards (``VIEW``, the replicated view operands above; ``LOOKUP``, the
  token lookup's gathered table; ``LOSS``, InfoNCE's replicated rows) and
  a decode step's writes into its caches and reads of them
  (``CACHE_WRITE``, ``CACHE_READ``) apart from the rest of what DTensor
  issues to carry the rules' layouts (``LAYOUT``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   register_sharding)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


LAYOUT, VIEW, LOOKUP, LOSS = "layout", "view", "lookup", "loss"
CACHE_WRITE, CACHE_READ = "cache-write", "cache-read"
_SOURCES = []


@contextlib.contextmanager
def collective_source(name: str):
    """Collectives issued inside are filed under ``name`` (the innermost
    name wins)."""
    _SOURCES.append(name)
    try:
        yield
    finally:
        _SOURCES.pop()


def current_source() -> str:
    return _SOURCES[-1] if _SOURCES else LAYOUT


@register_sharding(torch.ops.aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad_output, self, buffer):
    def buf(p):
        return Replicate() if buffer.tensor_meta.shape.numel() == 0 else p
    out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
    for dim in range(self.ndim):
        out.append(([Shard(dim)], [Shard(dim), Shard(dim), buf(Shard(dim))]))
    return out


def _order(stride, dims):
    """``dims`` from the outermost in memory to the innermost."""
    return sorted(dims, key=lambda d: (-stride[d], d))


def global_stride(local: torch.Tensor, shape) -> tuple:
    """Row-major strides of the global ``shape`` in the memory order of
    the local shard ``local`` (its dims from outermost to innermost)."""
    stride, n = [0] * len(shape), 1
    for d in reversed(_order(local.stride(), range(len(shape)))):
        stride[d] = n
        n *= max(shape[d], 1)
    return tuple(stride)


def _aligned(t):
    """A DTensor whose global strides state its local shard's memory
    order: the same local tensor, the same placements."""
    if not isinstance(t, DTensor):
        return t
    local = t._local_tensor
    dims = [d for d in range(t.ndim) if t.shape[d] > 1 and local.shape[d] > 1]
    if _order(local.stride(), dims) == _order(t.stride(), dims):
        return t
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=global_stride(local, t.shape))


class AlignedLayouts(TorchDispatchMode):
    """Keeps each DTensor's global strides in the order of its local
    shard's. DTensor gives an op's result the strides its fake run on the
    global shapes gives, which follow a permuted operand's; when it
    redistributes that operand first (a partial sum to a shard), the new
    local shard is row-major and the result's local shard too, so the two
    disagree, and a later view (an einsum's, a reshape's) of the shard
    fails. After each functional op on DTensors this restates the result's
    global strides from its local shard; views and in-place ops keep
    theirs (they alias their operand)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _VIEWS and isinstance(args[0], DTensor):
            return _view(func, args, kwargs)
        out = func(*args, **kwargs)
        if func.is_view or func._schema.is_mutable:
            return out
        return tree_map(_aligned, out)


_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}


def _view(func, args, kwargs):
    """A view of a DTensor; where DTensor cannot split a sharded dim as
    asked (a kv projection's 1024 columns over 16 devices viewed as 8
    heads of 128), the operand is replicated over the offending mesh dims,
    the last first, as XLA reshards before such a reshape. The result is
    then a new tensor, not a view (the models write into no such view)."""
    t = args[0]
    try:
        return func(*args, **kwargs)
    except RuntimeError as e:
        if "Sharding propagation failed" not in str(e):
            raise
        err = e
    pl = list(t.placements)
    for i in reversed(range(len(pl))):
        if not isinstance(pl[i], Shard):
            continue
        pl[i] = Replicate()
        try:
            with collective_source(VIEW):
                whole = t.redistribute(t.device_mesh, pl)
            return func(whole, *args[1:], **kwargs)
        except RuntimeError as e:
            if "Sharding propagation failed" not in str(e):
                raise
    raise err


def replicating(*tensors):
    """``implicit_replication()`` when a tensor is a ``DTensor``, else
    nothing: for a backward that reruns model code on DTensors (which
    makes masks and tables of its own), entered in the backward itself,
    since the autograd engine may run it on another thread than the
    step's."""
    if any(isinstance(t, DTensor) for t in tensors):
        return implicit_replication()
    return contextlib.nullcontext()
