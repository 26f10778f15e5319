"""Fault-tolerant checkpointing (a port of ``repro/checkpoint/manager.py``, in
its on-disk format, so a checkpoint of either package restores in the
other).

  * every leaf saved as .npy inside a staging dir (bf16 and float8 as a raw
    unsigned view, their dtype recorded); metadata (leaf names, dtypes,
    shapes, per-leaf sha256, the step and the caller's ``extra``) in
    ``META.msgpack``; ATOMIC publish via ``os.rename``: a died writer never
    corrupts the latest checkpoint;
  * async save on a background thread (training continues; ``wait()`` joins
    and re-raises a writer's error);
  * keep-N garbage collection;
  * integrity: checksums verified on load, torn checkpoints rejected.

Leaves are named and ordered as the reference's ``_flatten_with_paths``
names them (``repro_torch.tree``): dict keys sorted, NamedTuple fields in
order, tuple entries by index. ``restore`` puts them on a torch device, or,
with ``shardings=`` (a tree of ``distributed.sharding.NamedSharding``, as
``tree_shardings`` builds), lays each out as a DTensor on its sharding's
mesh: restore onto another topology.
"""
from __future__ import annotations

import hashlib
import io
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import tree as T
from .messagepack import packb, unpackb

# dtypes numpy cannot hold, stored as a raw view (the reference's views):
# name -> (the file's numpy dtype, an integer dtype of that width both
# numpy and torch hold)
_VIEW_DTYPES = {
    "bfloat16": (np.uint16, (np.int16, torch.int16)),
    "float8_e4m3fn": (np.uint8, (np.uint8, torch.uint8)),
    "float8_e5m2": (np.uint8, (np.uint8, torch.uint8)),
}


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_save: bool = True
    verify_on_load: bool = True


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[1]
    return str(np.asarray(x).dtype)


def _host_copy(x) -> np.ndarray:
    """A numpy snapshot of a leaf: copied, so a train step that updates the
    tensor in place after ``save`` returns cannot tear the checkpoint."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    t = x.detach().to("cpu", copy=True)
    name = _dtype_name(t)
    if name in _VIEW_DTYPES:
        file_dtype, (_, int_view) = _VIEW_DTYPES[name]
        return t.view(int_view).numpy().view(file_dtype)
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_DTYPES:
        _, (np_view, _) = _VIEW_DTYPES[dtype_name]
        return torch.from_numpy(arr.view(np_view)).view(getattr(torch, dtype_name))
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Checkpoint ``tree`` as ``step``. Leaves are copied to the host
        before this returns; the files are written on a thread
        (``async_save``) or here, where a failure raises at once."""
        leaves = [(name, _dtype_name(leaf), _host_copy(leaf))
                  for name, leaf in T.flatten_with_paths(tree)]
        if self.cfg.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, leaves, extra: Dict):
        stage = None
        try:
            stage = os.path.join(self.cfg.directory, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.cfg.directory, f"step_{step:010d}")
            os.makedirs(stage, exist_ok=True)
            meta = {"step": step, "extra": extra, "leaves": [],
                    "treedef": f"repro_torch tree of {len(leaves)} leaves"}
            for i, (name, dtype, arr) in enumerate(leaves):
                fn = f"leaf_{i:05d}.npy"
                path = os.path.join(stage, fn)
                np.save(path, arr)
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                meta["leaves"].append({"name": name, "file": fn, "sha256": digest,
                                       "dtype": dtype, "shape": list(arr.shape)})
            with open(os.path.join(stage, "META.msgpack"), "wb") as f:
                f.write(packb(meta))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(stage, final)      # atomic publish
            self._gc()
        except BaseException as e:       # raised again by wait()
            self._error = e
            if stage is not None:
                shutil.rmtree(stage, ignore_errors=True)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.cfg.keep] if self.cfg.keep > 0 else []:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.cfg.directory):
            if d.startswith("step_") and os.path.isdir(os.path.join(self.cfg.directory, d)):
                if os.path.exists(os.path.join(self.cfg.directory, d, "META.msgpack")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, target_tree: Any = None,
                device=None, shardings: Any = None):
        """Load ``step`` (default the latest). With ``target_tree`` (the same
        structure) returns (step, extra, the tree with the loaded leaves),
        each leaf on ``device`` or, by default, its target leaf's device,
        names, dtypes and shapes checked against the target's; without,
        {"step", "extra", "leaves" (tensors on ``device``, default the
        CPU), "names"}. ``shardings`` (with ``target_tree``, not with
        ``device``): a tree of the target's structure whose leaves are
        ``NamedSharding``s; each leaf is ``distribute_tensor``ed onto its
        sharding's mesh and placements (cross-topology resharding)."""
        if shardings is not None and device is not None:
            raise ValueError("restore takes device= or shardings=, not both")
        if shardings is not None and target_tree is None:
            raise ValueError("restore(shardings=) needs target_tree=")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.cfg.directory}")
        d = os.path.join(self.cfg.directory, f"step_{step:010d}")
        with open(os.path.join(d, "META.msgpack"), "rb") as f:
            meta = unpackb(f.read())
        tensors = []
        for leaf_meta in meta["leaves"]:
            path = os.path.join(d, leaf_meta["file"])
            with open(path, "rb") as f:
                raw = f.read()
            if self.cfg.verify_on_load:
                if hashlib.sha256(raw).hexdigest() != leaf_meta["sha256"]:
                    raise IOError(f"checksum mismatch in {path}: torn checkpoint")
            tensors.append(_to_tensor(np.load(io.BytesIO(raw)), leaf_meta["dtype"]))
        names = [l["name"] for l in meta["leaves"]]
        if target_tree is None:
            dev = torch.device(device) if device is not None else torch.device("cpu")
            return {"step": meta["step"], "extra": meta["extra"],
                    "leaves": [t.to(dev) for t in tensors], "names": names}
        flat = T.flatten_with_paths(target_tree)
        if [n for n, _ in flat] != names:
            raise ValueError(f"checkpoint {d} holds leaves {names}, the target "
                             f"{[n for n, _ in flat]}")
        out = []
        for (name, want), got in zip(flat, tensors):
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                raise ValueError(f"{name}: checkpoint {got.dtype} {tuple(got.shape)}, target "
                                 f"{want.dtype} {tuple(want.shape)}")
            out.append(got)
        if shardings is not None:
            from ..distributed.sharding import distribute

            shard_flat = T.leaves(shardings)
            if len(shard_flat) != len(out):
                raise ValueError(f"{len(shard_flat)} shardings for {len(out)} leaves")
            out = [distribute(t, sh) for t, sh in zip(out, shard_flat)]
        else:
            out = [t.to(want.device if device is None else device)
                   for t, (_, want) in zip(out, flat)]
        return meta["step"], meta["extra"], T.unflatten(target_tree, out)
