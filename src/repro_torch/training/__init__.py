"""Training of the LM families on the card (a port of ``repro/training``)."""
from .optimizer import AdamWConfig, AdamWState, init as adamw_init, apply as adamw_apply
from .losses import chunked_softmax_xent, full_softmax_xent
from .compression import CompressionConfig, compress_grads, init_error
from .train_step import TrainConfig, build_loss_fn, build_train_step, init_state

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_apply",
    "chunked_softmax_xent",
    "full_softmax_xent",
    "CompressionConfig",
    "compress_grads",
    "init_error",
    "TrainConfig",
    "build_loss_fn",
    "build_train_step",
    "init_state",
]
