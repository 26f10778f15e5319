"""Per-device cost of a traced call, for the roofline: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference walks the compiled per-device HLO text. PyTorch compiles no
such program, so this module analyses the stream of aten ops that one call
dispatches instead. Run over DTensors on a device mesh (the dry run runs
them on fake tensors over a fake process group), every op is counted on the
local tensors of one rank: the per-device counts. An op that meets a DTensor
is left to DTensor, whose local ops then come back through the counter; the
global-shape op that DTensor's sharding propagation runs once per new
signature, to learn its output's shape, is not counted.

  * products: ``mm``/``bmm``/``addmm``/``baddbmm`` and convolutions count
    2 x result elements x contraction size, exactly;
  * elementwise ops count 1 FLOP per result element, for the counterparts
    of the reference's HLO set (add, subtract, multiply, divide, maximum,
    minimum, exponential, rsqrt, sqrt, tanh, logistic, log, negate, power,
    compare, select); every other op counts no FLOPs, as there;
  * collectives count their operand bytes per kind, under the reference's
    names: ``_c10d_functional``'s ``all_gather_into_tensor``, ``all_reduce``,
    ``reduce_scatter_tensor`` and ``all_to_all_single`` (DTensor's
    ``shard_dim_alltoall`` too), ``c10d``'s in-place collectives, and a
    point-to-point send as ``collective-permute``. A CPU process group has
    no all-to-all: DTensor then gathers and chunks, so a mesh of
    ``device_type="cpu"`` shows all-gathers where one of ``"cuda"`` shows
    all-to-alls;
  * bytes: the operands and results of every op that is not a view, an
    allocation (``empty``), a ``prim`` or a wait (the counterparts of the
    reference's bitcast, parameter and tuple exclusions). Eager PyTorch
    fuses nothing, so this estimates unfused HBM traffic: more than a
    fused program moves.

Python loops are seen op by op, so no loop has an unknown trip count and
``unknown_trip_loops`` is always 0. A loop that the port marks as trips of
one body (``repro_torch.loops.trips``: the microbatches of a train step and
the steps of the sequential SSD recurrence) is traced once and its counts
multiplied by its trip count, as the reference multiplies a ``while`` body.
The multiplier follows the body's autograd nodes into the backward, which
runs after the loop.

``Counter`` also keeps the peak of the live local tensors that the call's
ops made (``peak_bytes``; the call's inputs are not among them): the dry
run's ``temp_bytes``. A folded loop holds one trip's tensors.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import loops

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_ELEMENTWISE = {
    "add", "sub", "mul", "div", "maximum", "minimum", "exp", "rsqrt", "sqrt",
    "tanh", "sigmoid", "log", "neg", "pow", "eq", "ne", "lt", "le", "gt", "ge",
    "where",
}

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm"}
_CONVOLUTIONS = {"convolution", "_convolution", "convolution_overrideable"}

# op name -> (collective kind, index of the operand in the op's arguments)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_reduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", 0),
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "c10d", "_dtensor"}
_UNCOUNTED = {"wait_tensor", "empty", "empty_like", "empty_strided", "detach", "alias",
              "lift_fresh"}


@dataclass
class HloCost:
    flops: float
    bytes: float
    collectives: Dict[str, float]
    unknown_trip_loops: int

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _fresh_outputs(func) -> bool:
    """Whether the op's results are new tensors (no return aliases an
    input: not a view, not an in-place or ``out=`` op)."""
    return all(r.alias_info is None for r in func._schema.returns)


class _Propagation:
    """DTensor's own bookkeeping, which the counter does not count: the
    sharding propagator runs an op on global-shape fake tensors, once per
    new signature, to learn its output's shape; and a shard's offsets are
    computed with small tensors, which under ``FakeTensorMode`` would be
    fake and could not be read back (a strided shard's offsets fail so), so
    they are computed outside it."""

    def __init__(self):
        self.depth = 0
        self._patched = []

    def _wrap(self, owner, name, real: bool):
        import inspect

        raw = inspect.getattr_static(owner, name, None)
        if raw is None:
            return
        kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
        orig = getattr(owner, name)
        outer = self

        def wrapped(*args, **kwargs):
            outer.depth += 1
            try:
                if real:
                    from torch._subclasses.fake_tensor import unset_fake_temporarily

                    with unset_fake_temporarily():
                        return orig(*args, **kwargs)
                return orig(*args, **kwargs)
            finally:
                outer.depth -= 1

        setattr(owner, name, staticmethod(wrapped) if kind is not None else wrapped)
        self._patched.append((owner, name, raw))

    def install(self):
        from torch.distributed.tensor import _utils, placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            name = "_propagate_tensor_meta"
        self._wrap(ShardingPropagator, name, real=False)
        for name in ("_get_shard_size_and_offsets", "_get_first_offset"):
            self._wrap(_utils, name, real=True)
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            for name in ("local_shard_size_and_offset", "_local_shard_size_and_offset"):
                self._wrap(strided, name, real=True)

    def remove(self):
        while self._patched:
            owner, name, orig = self._patched.pop()
            setattr(owner, name, orig)


class _Ops(TorchDispatchMode):
    def __init__(self, counter: "Counter"):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.c._prop.depth:
            return func(*args, **kwargs)
        if any(_is_dtensor(a) for a in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        out = func(*args, **kwargs)
        self.c._count(func, args, kwargs, out)
        return out


class _Nodes(TorchFunctionMode):
    """Inside a folded loop, tags each new autograd node with the loop's
    multiplier, which its backward then runs under."""

    def __init__(self, counter: "Counter"):
        super().__init__()
        self.c = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        scale = self.c._scale[-1]
        if scale != 1.0:
            stack = self.c._scale

            def push(grad_outputs):
                stack.append(scale)

            def pop(grad_inputs, grad_outputs):
                stack.pop()

            for t in _tensors(out):
                node = t.grad_fn
                if node is not None:
                    node.register_prehook(push)
                    node.register_hook(pop)
        return out


class Counter:
    """A context in which every dispatched op is counted per device.

    ``cost()`` is the ``HloCost`` of what ran inside; ``peak_bytes`` the
    most bytes of the call's own live tensors at once; ``ops`` the number
    of ops dispatched on local tensors. One counter runs at
    a time (it patches DTensor's sharding propagator while it runs)."""

    _active_lock = threading.Lock()

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = defaultdict(float)
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        # not thread-local: the autograd engine runs a CUDA backward on a
        # thread of its own, while the caller waits
        self._scale: List[float] = [1.0]
        self._prop = _Propagation()
        self._modes = []

    # loops' folder protocol
    def enter(self, n: int):
        self._scale.append(self._scale[-1] * n)

    def exit(self):
        self._scale.pop()

    def __enter__(self):
        if not Counter._active_lock.acquire(blocking=False):
            raise RuntimeError("another hlo_analysis.Counter is running")
        self._prop.install()
        loops._folder = self
        self._modes = [_Nodes(self), _Ops(self)]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        loops._folder = None
        self._prop.remove()
        Counter._active_lock.release()
        return False

    def _free(self, n: int):
        self.live_bytes -= n

    def _count(self, func, args, kwargs, out):
        self.ops += 1
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "prim" or name in _UNCOUNTED:
            if name.startswith("empty") and _fresh_outputs(func):
                self._track(out)
            return
        s = self._scale[-1]
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                operand = args[kind[1]] if len(args) > kind[1] else None
                self.collectives[kind[0]] += s * sum(_nbytes(t) for t in _tensors(operand))
            if _fresh_outputs(func):
                self._track(out)
            return
        fresh = _fresh_outputs(func)
        if not fresh and not any(r.alias_info.is_write for r in func._schema.returns
                                 if r.alias_info is not None):
            return                                      # a view
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += s * (sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs
                                                                if fresh))
        if name in _PRODUCTS:                            # (.., m, k) @ (.., k, n)
            self.flops += s * 2.0 * outs[0].numel() * args[-2].shape[-1]
        elif name in _CONVOLUTIONS:                      # weight (C_out, C_in/groups, *k)
            w = args[1]
            self.flops += s * 2.0 * outs[0].numel() * (w.numel() // max(w.shape[0], 1))
        elif name.rstrip("_") in _ELEMENTWISE and outs:
            self.flops += s * outs[0].numel()
        if fresh:
            self._track(out)

    def _track(self, out):
        for t in _tensors(out):
            n = _nbytes(t)
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def cost(self) -> HloCost:
        return HloCost(flops=self.flops, bytes=self.bytes,
                       collectives={k: v for k, v in self.collectives.items()},
                       unknown_trip_loops=0)


def analyze(fn: Callable, *args, **kwargs) -> HloCost:
    """The per-device ``HloCost`` of ``fn(*args, **kwargs)``."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.cost()


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Trip-count-aware collective operand bytes per kind of ``fn(*args)``."""
    return {k: int(v) for k, v in analyze(fn, *args, **kwargs).collectives.items()}
