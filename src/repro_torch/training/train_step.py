"""Train-step builder: loss (chunked CE) -> grads -> compression -> AdamW (a
port of ``repro/training/train_step.py``).

One builder covers every family. The loss runs the models' training route,
``use_pallas=False``: the reference's plain jnp oracles, which autograd
differentiates (no kernel of the port or of the reference has a backward,
so ``TrainConfig(use_pallas=True)`` is refused), with each layer under
``torch.utils.checkpoint`` (``remat``). Gradients accumulate over
microbatches in f32, in batch order (the microbatches are trips of one
body, ``loops.trips``; a batch sharded over its rows gives each rank its
share of every microbatch, ``distributed.sharding.row_slice``). The state's tensors are updated in
place (``optimizer.apply``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Union

import torch

from .. import loops
from .. import tree as T
from ..device import DeviceLike, resolve_device
from ..distributed.sharding import fsdp_unshard, row_slice
from ..models import family_module
from ..models.config import ArchConfig
from . import compression, losses, optimizer


@dataclass(frozen=True)
class TrainConfig:
    adamw: optimizer.AdamWConfig = field(default_factory=optimizer.AdamWConfig)
    compression: compression.CompressionConfig = field(
        default_factory=compression.CompressionConfig
    )
    loss_chunk: int = 512
    remat: bool = True
    use_pallas: bool = False
    microbatches: int = 1


def init_state(seed: Union[int, torch.Generator], cfg: ArchConfig, tcfg: TrainConfig, *,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """{"params", "opt", "step"[, "err"]}: the family's parameters as the
    reference's nested dict of tensors, drawn on ``device`` (the card unless
    the caller asks for the CPU) from ``seed`` (an int seeds a generator on
    that device), the AdamW moments, a step counter and, with error
    feedback, the compression residual."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    params = family_module(cfg).init_params(cfg, generator=gen, device=dev)
    state = {
        "params": params,
        "opt": optimizer.init(params, tcfg.adamw),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if tcfg.compression.enabled and tcfg.compression.error_feedback:
        state["err"] = compression.init_error(params)
    return state


def _head_weight(params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings or "head" not in params:
        return fsdp_unshard(params["embed"])["table"].T
    return fsdp_unshard({"head": params["head"]})["head"]["w"]


def build_loss_fn(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """loss_fn(params, batch) -> the mean token loss (f32 scalar); batch holds
    "tokens" and "labels" (B, S), and the audio family's "frames" (B, S_enc,
    D). With ``tcfg.use_pallas`` the forward runs the kernels, which
    autograd cannot differentiate: for evaluation only."""
    mod = family_module(cfg)

    def loss_fn(params, batch):
        if cfg.family == "audio":
            enc = mod.encode(params, batch["frames"], cfg, use_pallas=tcfg.use_pallas)
            hidden, _ = mod.decode_hidden(params, batch["tokens"], mod.cross_kv(params, enc, cfg),
                                          cfg, use_pallas=tcfg.use_pallas)
        else:
            hidden = mod.final_hidden(params, batch["tokens"], cfg,
                                      use_pallas=tcfg.use_pallas, remat=tcfg.remat)
        chunk = min(tcfg.loss_chunk, hidden.shape[1])
        while hidden.shape[1] % chunk:
            chunk -= 1
        return losses.chunked_softmax_xent(hidden, _head_weight(params, cfg), batch["labels"],
                                           chunk=chunk)

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor]):
    """(loss, grads): the gradients of ``loss_fn(params, batch)`` with
    respect to every leaf of ``params``, a tree of their structure (zeros
    for a leaf the loss does not read, as JAX gives). The leaves are
    detached views that require grad; ``params`` is not changed."""
    leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), T.unflatten(params, grads)


def build_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """train_step(state, batch) -> (state, metrics {"loss", "lr", "grad_norm"[,
    "compression_ratio"]}). The state's parameters and moments are updated
    in place; the returned state holds them with the new step."""
    if tcfg.use_pallas:
        raise NotImplementedError(
            "TrainConfig(use_pallas=True): no kernel has a backward (the reference's Pallas "
            "kernels neither); train on the plain route, use_pallas=False")
    loss_fn = build_loss_fn(cfg, tcfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        n = tcfg.microbatches
        if n > 1:
            loss = torch.zeros((), dtype=torch.float32, device=T.leaves(params)[0].device)
            grads = T.map_up_to(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in loops.trips(n):
                mb = {k: row_slice(v, n, i) for k, v in batch.items()}
                mb_loss, mb_grads = value_and_grad(loss_fn, params, mb)
                T.map_up_to(lambda acc, g: acc.add_(g), grads, mb_grads)
                loss = loss + mb_loss
            loss = loss / n
            grads = T.map_up_to(lambda g: g / n, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        metrics = {"loss": loss}
        new_state = dict(state)
        if tcfg.compression.enabled:
            grads, new_err, cm = compression.compress_grads(
                grads, state.get("err"), tcfg.compression)
            new_state["err"] = new_err
            metrics.update(cm)

        new_params, new_opt, om = optimizer.apply(params, grads, state["opt"], tcfg.adamw)
        metrics.update(om)
        new_state.update(params=new_params, opt=new_opt, step=state["step"] + 1)
        return new_state, metrics

    return train_step
