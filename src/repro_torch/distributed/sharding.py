"""Sharding rules: parameter / batch / cache partition specs per
architecture (a port of ``repro/distributed/sharding.py``).

2D "FSDP x TP" layout (MaxText-style) on mesh axes (data, model), optionally
with a leading pod axis for multi-pod runs:

  * (in, out) projections:   P(data, model)   — out-dim TP, in-dim FSDP
  * (in, out) down/out proj: P(model, data)   — in-dim TP (contracting)
  * embedding (V, D):        P(model, data)   — vocab-parallel
  * lm head (D, V):          P(data, model)   — vocab-parallel logits
  * MoE expert stacks (E, D, F): P(model, data, None) — EP on the model axis
  * vectors / norms: replicated

Every rule is divisibility-checked against the mesh; a non-divisible dim
falls back to replication for that axis. Stacked layer leaves (leading scan
dim) get a leading None.

A spec is a ``PartitionSpec``: a tuple of per-dimension mesh axis names
(None, a name, or a tuple of names whose product the dimension spans).
The rules read axis sizes from a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``, ``shape``) or from a dict of sizes, and take a tree
(``repro_torch.tree``: dicts, NamedTuples, tuples, lists) of anything with a
``.shape``, so specs need no devices. Leaf paths are the names
``tree.flatten_with_paths`` gives, the checkpoint format's, which the
reference's rules read too (an int8 moment's ``(q, scales)`` pair is
``.../0`` and ``.../1``).

``NamedSharding`` (``make_sharding``, ``tree_shardings``) turns a spec on a
``DeviceMesh`` into DTensor placements: a mesh dimension that a tensor
dimension's spec names is ``Shard(dim)``, any other ``Replicate()``; a
dimension over a tuple of axes is sharded over each of them in mesh order,
the first the most significant, as JAX lays out a tuple axis.

The in-model hints (``fsdp_unshard``, ``activation_constraint``,
``constrain``, ``shard_attention_q``) read the mesh set by ``set_mesh``:
without one they return their input; under one they redistribute a DTensor
input to the reference's spec (any other input is returned as it is). The
models call them where the reference does, so the dry run over the
production meshes (``launch.dryrun``) lays the activations out as GSPMD
does there. Three helpers run what DTensor has no sharding rule for on
each rank's own shard, and are the plain computation without a mesh or a
DTensor: ``group_local`` (the MoE's data-dependent dispatch and combine,
over its dp-sharded groups), ``heads_local`` and ``batch_heads_local``
(attention and the SSD recurrence, on each rank's batch rows and heads, as
GSPMD partitions them: DTensor would merge a dp-sharded batch with
model-sharded heads into one dimension for its batched products),
``write_slice`` (a cache write into a sequence-sharded cache) and
``row_slice`` (a train step's microbatch of a batch sharded over its rows).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tree as T

# params stacked under these keys carry leading scan dims
_STACK_DEPTH = {"layers": 1, "groups": 2, "enc_layers": 1, "dec_layers": 1}

_OUT_TP = {"wq", "wk", "wv", "wg", "wu", "w1", "in_z", "in_xbc", "in_dt",
           "w_dkv", "w_uk", "w_uv", "router"}
_IN_TP = {"wo", "wd", "w2", "out_proj"}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor: ``PartitionSpec("data",
    None)``; an entry may be a tuple of axis names. Equal to the tuple of
    its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of a dict of sizes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(axes: dict, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(np.prod([axes[n] for n in name]))
    return axes[name]


def _fit(dim: int, ax, axes: dict):
    """Return ax if dim divides evenly on it, else None (replicate)."""
    return ax if ax is not None and dim % _axis_size(axes, ax) == 0 else None


def _leaf_spec(path_keys, shape, axes, data_ax, model_ax) -> PartitionSpec:
    name = path_keys[-1]
    # quantized optimizer moments: tuple (int8 q, fp32 scales) under the
    # weight's path — q keeps the weight's spec; scales drop the last axis
    if name in ("0", "1") and len(path_keys) >= 2 and any(
        k in ("mu", "nu") for k in path_keys
    ):
        base = _leaf_spec(path_keys[:-1], shape, axes, data_ax, model_ax)
        if name == "1" and len(base) >= 1:
            return P(*base[:-1], None)
        return base
    stack = 0
    in_moe = False
    for k in path_keys:
        if k in _STACK_DEPTH:
            stack = _STACK_DEPTH[k]
        if k == "moe":
            in_moe = True
    core_rank = len(shape) - stack
    lead = (None,) * stack

    def spec(*want):
        fitted = tuple(_fit(shape[stack + i], ax, axes) for i, ax in enumerate(want))
        return P(*lead, *fitted)

    if core_rank <= 1:
        return P(*lead, *(None,) * max(core_rank, 0))

    if in_moe and core_rank == 3 and name in ("wg", "wu"):
        return spec(model_ax, data_ax, None)        # (E, D, F)
    if in_moe and core_rank == 3 and name == "wd":
        return spec(model_ax, None, data_ax)        # (E, F, D)
    if name == "table":                              # embedding (V, D)
        return spec(model_ax, data_ax)
    if name == "w" and "head" in path_keys:          # lm head (D, V)
        return spec(data_ax, model_ax)
    if name == "pos_dec":
        return spec(None, data_ax)
    if name == "conv_w":                             # (W, Ch)
        return spec(None, model_ax)
    if name in _OUT_TP and core_rank == 2:
        return spec(data_ax, model_ax)
    if name in _IN_TP and core_rank == 2:
        return spec(model_ax, data_ax)
    if name in ("w", "w1", "w2") and core_rank == 2:  # dlrm mlps etc.
        return spec(data_ax, model_ax)
    return P(*lead, *(None,) * core_rank)


def _path_names(path: str) -> Tuple[str, ...]:
    """A ``tree.flatten_with_paths`` path as the reference's key names."""
    return tuple(path.split("/")) if path else ()


def _map_with_paths(fn, tree: Any) -> Any:
    flat = T.flatten_with_paths(tree)
    return T.unflatten(tree, [fn(_path_names(p), leaf) for p, leaf in flat])


def param_specs(params_shape: Any, mesh, *, data_ax="data", model_ax="model",
                fsdp_over_pod: bool = True) -> Any:
    """PartitionSpec tree for a params (shape) tree.

    On multi-pod meshes, FSDP additionally spans the pod axis
    (``fsdp_over_pod``) so optimizer state divides across all chips.
    """
    axes = mesh_axes(mesh)
    d_ax = data_ax
    if fsdp_over_pod and "pod" in axes and axes["pod"] > 1:
        d_ax = ("pod", data_ax)
    return _map_with_paths(
        lambda names, leaf: _leaf_spec(names, tuple(leaf.shape), axes, d_ax, model_ax),
        params_shape)


def _dp(axes: dict):
    """The batch axes: (pod, data) where the mesh has a pod axis."""
    return ("pod", "data") if "pod" in axes else ("data",)


def batch_spec(shape, mesh) -> PartitionSpec:
    """Token batches: batch over (pod, data); seq replicated — except
    long_500k (batch=1) where the sequence shards over data (SP)."""
    axes = mesh_axes(mesh)
    dp = _dp(axes)
    if shape.global_batch % _axis_size(axes, dp) == 0:
        return P(dp if len(dp) > 1 else dp[0], None)
    if shape.seq_len % axes["data"] == 0:
        return P(None, "data")                      # sequence parallelism
    return P(None, None)


def kv_cache_spec(cfg, shape, mesh) -> PartitionSpec:
    """Spec for (L, B, Hkv, S, dh) caches (or MLA latent (L, B, S, w))."""
    axes = mesh_axes(mesh)
    dp = _dp(axes)
    b_ok = shape.global_batch % _axis_size(axes, dp) == 0
    b_ax = (dp if len(dp) > 1 else dp[0]) if b_ok else None

    if cfg.mla is not None:
        s_ax = "model" if shape.seq_len % axes["model"] == 0 else None
        return P(None, b_ax, s_ax, None)

    hkv, dh = cfg.n_kv_heads, cfg.attn_head_dim
    if hkv and hkv % axes["model"] == 0:
        return P(None, b_ax, "model", None, None)
    if not b_ok and shape.seq_len % axes["data"] == 0:
        # long-context single-batch: shard the KV sequence (ring/LSE decode)
        return P(None, None, None, "data", None)
    if dh and dh % axes["model"] == 0:
        return P(None, b_ax, None, None, "model")
    return P(None, b_ax, None, None, None)


def greedy_spec(shape: Sequence[int], mesh, priorities) -> PartitionSpec:
    """Assign mesh axes to dims by priority, respecting divisibility.

    ``priorities``: iterable of (dim_index, axis_name); first fit wins, each
    axis used at most once. Used for serve-time caches (SSM states, conv
    states) whose best layout varies by arch geometry.
    """
    axes = mesh_axes(mesh)
    assigned = {}
    used = set()
    for dim, ax in priorities:
        if dim in assigned or ax in used or ax not in axes:
            continue
        if 0 <= dim < len(shape) and shape[dim] % axes[ax] == 0:
            assigned[dim] = ax
            used.add(ax)
    return P(*[assigned.get(i) for i in range(len(shape))])


# --------------------------------------------------------------------------
# Specs on a DeviceMesh: DTensor placements
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the counterpart of JAX's
    ``NamedSharding``, read as DTensor ``placements``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(d)`` where tensor
    dimension ``d``'s spec names that mesh axis (alone or in a tuple, whose
    names must follow the mesh's order), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: the axes {group} of dimension {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} uses mesh axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def make_sharding(mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def tree_shardings(mesh, specs: Any) -> Any:
    """A ``NamedSharding`` for each spec of a spec tree."""
    return T.unflatten(specs, [NamedSharding(mesh, s) for s in T.leaves(specs, is_leaf=_is_spec)],
                       is_leaf=_is_spec)


def distribute(x, sharding: NamedSharding):
    """``x`` as a DTensor laid out by ``sharding``, each rank keeping its
    shard of its own ``x``: for a value every rank holds alike, as each
    reads the same checkpoint (no broadcast)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


# --------------------------------------------------------------------------
# In-model hints
# --------------------------------------------------------------------------

# Not thread-local: the autograd engine runs a CUDA backward, and the layers
# it recomputes there, on a thread of its own.
_current = [None]


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the one the in-model hints read, in every thread of the
    process, for the block (the counterpart of JAX's abstract mesh)."""
    prev = _current[0]
    _current[0] = mesh
    try:
        yield mesh
    finally:
        _current[0] = prev


def current_mesh():
    return _current[0]


def _constrain_to(x, spec: PartitionSpec, grad: bool = True):
    """Redistribute a DTensor ``x`` to ``spec`` on the current mesh; with
    ``grad``, its gradient too, as JAX constrains the cotangent of a
    sharding constraint to the same sharding (GSPMD would lay the backward
    out by propagation; DTensor keeps whatever layout a gradient arrives
    in, and a loss's gradient arrives replicated)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = current_mesh()
    pl = placements(mesh, spec)
    return _Constrain.apply(x, mesh, pl) if grad else x.redistribute(mesh, pl)


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is redistributed the same way."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.pl), None, None


def _hint_axes(required: Optional[str]) -> Optional[dict]:
    mesh = current_mesh()
    if mesh is None:
        return None
    axes = mesh_axes(mesh)
    if not axes or (required is not None and required not in axes):
        return None
    return axes


def _dp_of(axes: dict):
    """(the batch axis or axes, their total size) for the hints."""
    dp = ("pod", "data") if axes.get("pod", 1) > 1 else ("data",)
    return (dp if len(dp) > 1 else dp[0]), int(np.prod([axes.get(a, 1) for a in dp]))


def fsdp_unshard(params: Any) -> Any:
    """Constrain parameters to their TP-only (data-axis-gathered) layout,
    P(None, model) at point of use: a per-layer weight all-gather instead
    of all-reduced activations (ZeRO-3 semantics). No-op without a mesh."""
    axes = _hint_axes("model")
    if axes is None:
        return params

    def fn(names, leaf):
        if not hasattr(leaf, "shape") or leaf.dim() < 2:
            return leaf
        # the gradient goes back to the parameter's own layout (a
        # reduce-scatter over the data axes), as GSPMD's does for FSDP
        return _constrain_to(leaf, _leaf_spec(names, tuple(leaf.shape), axes, None, "model"),
                             grad=False)

    return _map_with_paths(fn, params)


def activation_constraint(x: Any, batch_dim: int = 0) -> Any:
    """Pin activations to the canonical batch-sharded layout (P(dp, None,
    ...)); sequence sharding when the batch does not divide (long_500k);
    no-op without a mesh."""
    axes = _hint_axes("data")
    if axes is None:
        return x
    dp_ax, dp_size = _dp_of(axes)
    spec = [None] * x.dim()
    if x.shape[batch_dim] % dp_size == 0:
        spec[batch_dim] = dp_ax
    elif x.dim() > batch_dim + 1 and x.shape[batch_dim + 1] % axes["data"] == 0:
        spec[batch_dim + 1] = "data"       # sequence parallelism
    return _constrain_to(x, P(*spec))


def constrain(x: Any, *want) -> Any:
    """Guarded sharding constraint: 'dp' expands to the data(+pod) axes;
    non-divisible or absent axes fall back to None; no-op without a mesh."""
    axes = _hint_axes(None)
    if axes is None:
        return x
    dp_ax, dp_size = _dp_of(axes)
    spec = []
    for dim, ax in zip(x.shape, want):
        if ax == "dp":
            spec.append(dp_ax if (dim % dp_size == 0 and "data" in axes) else None)
        elif ax is not None and ax in axes and dim % axes[ax] == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return _constrain_to(x, P(*spec))


def shard_attention_q(q: Any) -> Any:
    """Keep attention score compute sharded when heads don't divide TP:
    q (B, H, S, dh) over heads when they divide the model axis, else over
    the query sequence; no-op without a mesh."""
    axes = _hint_axes("model")
    if axes is None:
        return q
    m = axes["model"]
    dp_ax, dp_size = _dp_of(axes)
    b_ax = dp_ax if q.shape[0] % dp_size == 0 else None
    if q.shape[1] % m == 0:
        return _constrain_to(q, P(b_ax, "model", None, None))
    if q.shape[2] % m == 0:
        return _constrain_to(q, P(b_ax, None, "model", None))
    return q


# --------------------------------------------------------------------------
# Rank-local pieces of a sharded computation
# --------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def group_local(fn, *args, grouped: Sequence[bool], n_out: int):
    """``fn(*args)`` -> ``n_out`` tensors, run on each rank's groups.

    Every output and each tensor argument marked in ``grouped`` has the
    group dimension first; under a mesh it is laid out as ``constrain(x,
    "dp", ...)`` lays it out (over the data(+pod) axes when the groups
    divide them, else replicated), and the other arguments are replicated.
    ``fn`` then runs on the local tensors (``local_map``): the reference's
    constraints keep its dispatch groups shard-local, which this is. Without
    a mesh or a DTensor argument it is ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    axes = mesh_axes(mesh)
    dp_ax, dp_size = _dp_of(axes)
    G = next(a for a, g in zip(args, grouped) if g).shape[0]
    g_spec = P(dp_ax if G % dp_size == 0 and "data" in axes else None)
    return _local_map(fn, args, [g_spec if g else P() for g in grouped], [g_spec] * n_out, mesh)


def _local_map(fn, args, in_specs, out_specs, mesh):
    """``local_map`` of ``fn`` with each tensor argument laid out by its
    spec (a plain tensor taken as replicated), outputs by theirs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    r_pl = placements(mesh, P())
    ins, in_pl = [], []
    for a, spec in zip(args, in_specs):
        if isinstance(a, torch.Tensor) and not _is_dtensor(a):
            a = DTensor.from_local(a, mesh, r_pl, run_check=False)
        ins.append(a)
        in_pl.append(placements(mesh, spec) if isinstance(a, torch.Tensor) else None)
    out_pl = [placements(mesh, spec) for spec in out_specs]
    return local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1 else list(out_pl[0]),
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*ins)


def batch_heads_local(fn, *args, heads: Sequence[Optional[int]], n_out: int):
    """``fn(*args)`` -> ``n_out`` tensors, on each rank's batch rows and
    heads: dimension 0 of every tensor is the batch, over the data(+pod)
    axes when they divide it; ``heads[i]`` is argument i's head dimension
    (None: it has none), over the model axis when it divides every one.
    Every output has the batch first and its heads at dimension 1. Without a
    mesh or a DTensor argument it is ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    axes = mesh_axes(mesh)
    dp_ax, dp_size = _dp_of(axes)
    b_ax = dp_ax if args[0].shape[0] % dp_size == 0 and "data" in axes else None
    h_ax = "model" if "model" in axes and all(
        args[i].shape[d] % axes["model"] == 0 for i, d in enumerate(heads) if d is not None
    ) else None

    def spec(d):
        return P(b_ax) if d is None else P(b_ax, *([None] * (d - 1)), h_ax)

    return _local_map(fn, args, [spec(d) for d in heads], [spec(1)] * n_out, mesh)


def heads_local(fn, q, k, v):
    """``fn(q, k, v, q_offset)`` -> (B, H, Sq, dv): attention (q (B, H, Sq,
    d), k and v (B, Hkv, Sk, .)) on each rank's batch rows and heads, as
    ``shard_attention_q`` lays q out: heads over the model axis when they
    divide it (too few kv heads to split are repeated to one per query
    head), else the query rows, ``q_offset`` then being this rank's first
    row; the batch over the data(+pod) axes when they divide it. Without a
    mesh or a DTensor argument it is ``fn(q, k, v, 0)``."""
    mesh = current_mesh()
    if mesh is None or not any(_is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v, 0)
    axes = mesh_axes(mesh)
    dp_ax, dp_size = _dp_of(axes)
    B, H, Sq = q.shape[:3]
    b_ax = dp_ax if B % dp_size == 0 and "data" in axes else None
    m = axes.get("model")
    row0 = 0
    if m and H % m == 0:
        if k.shape[1] % m:
            k = k.repeat_interleave(H // k.shape[1], dim=1)
            v = v.repeat_interleave(H // v.shape[1], dim=1)
        q_spec = kv_spec = P(b_ax, "model")
    elif m and Sq > 1 and Sq % m == 0:
        q_spec, kv_spec = P(b_ax, None, "model"), P(b_ax)
        row0 = mesh.get_local_rank("model") * (Sq // m)
    else:
        q_spec = kv_spec = P(b_ax)
    return _local_map(lambda q, k, v: fn(q, k, v, row0), (q, k, v),
                      (q_spec, kv_spec, kv_spec), (q_spec,), mesh)


def write_slice(dst, src, dim: int, start: int) -> bool:
    """``dst[..., start:start + n, ...] = src`` along ``dim`` in place, for
    a DTensor ``dst``: ``src`` is laid out as ``dst`` except along ``dim``
    (whole there), and each rank writes the part that falls in its shard.
    Returns False, writing nothing, when ``dst`` is not a DTensor."""
    if not _is_dtensor(dst):
        return False
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    src_pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in dst.placements]
    local_src = src.redistribute(mesh, src_pl).to_local()
    # this rank's rows of dim: each mesh dimension that shards it splits the
    # rows left so far into chunks of ceil(n / size), in mesh order
    lo, n = 0, dst.shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-n // mesh.size(i))
            first = min(coord[i] * chunk, n)
            lo, n = lo + first, min(chunk, n - first)
    hi = lo + n
    a, b = max(start, lo), min(start + src.shape[dim], hi)
    if a < b:
        local = dst.to_local()
        local.narrow(dim, a - lo, b - a).copy_(local_src.narrow(dim, a - start, b - a))
    return True


def row_slice(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a batch tensor (rows first): the i-th
    n-th of an unsharded ``x``'s rows. A DTensor sharded over its rows
    gives each rank the i-th of n slices of its own rows instead, so every
    rank takes its share of every microbatch (the microbatch's rows are then
    a strided set, as each rank's slice of a scanned microbatch is)."""
    from torch.distributed.tensor import DTensor, Shard

    if not (_is_dtensor(x) and any(isinstance(p, Shard) and p.dim == 0
                                   for p in x.placements)):
        return x.reshape(n, -1, *x.shape[1:])[i]
    local = x.to_local()
    part = local.reshape(n, -1, *local.shape[1:])[i]
    return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
