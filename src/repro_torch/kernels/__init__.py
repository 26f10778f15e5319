"""Hand-written CUDA kernels of the port, each beside its plain torch version.

| Kernel | Wrapper | Replaces (JAX package) |
| --- | --- | --- |
| K1 cache scan | ``cache_scan.cache_scan_groups`` | ``kernels/cache_scan.py:_cache_scan_kernel`` |
| K2 stack distance | ``stack_distance.stack_distance_groups`` | ``kernels/stack_distance.py:_stack_distance_kernel`` |
| D1 DRAM event scan | ``dram_scan.dram_scan_chunked`` | the ``lax.scan`` of ``core/memory/dram.py:_scan_channel_chunked`` |
| D2 FIFO / SRRIP row scans | ``rrip_scan.rrip_scan_flat`` | the ``lax.scan`` s of ``core/memory/rrip.py:_fifo_scan_rows`` and ``_srrip_scan_rows`` |
| K3 embedding bag | ``embedding_bag.embedding_bag_kernel`` | ``kernels/embedding_bag.py:_bag_kernel`` |
| K4 row gather | ``embedding_bag.embedding_gather_kernel`` | ``kernels/embedding_bag.py:_gather_kernel`` |
| K5 hot-pinned pool | ``embedding_bag.vmem_gather_pool_kernel`` | ``kernels/embedding_bag.py:_vmem_pool_kernel`` |
| K6 flash attention | ``flash_attention.flash_attention_kernel`` | ``kernels/flash_attention.py:_flash_kernel`` |
| K7 decode attention | ``decode_attention.decode_attention_kernel`` | ``kernels/decode_attention.py:_decode_kernel`` |
| K8 Mamba2 SSD scan | ``mamba2_ssd.mamba2_ssd_kernel`` | ``kernels/mamba2_ssd.py:_ssd_kernel`` |

Each wrapper counts its launches in a ``launches`` attribute, incremented
only where it launches its CUDA kernel; K6, K8 and D2 also count them by route
(``flash_attention_kernel.routes``: the bf16 tensor-core kernel, "wgmma",
and the f32 scalar kernel, "scalar"; ``mamba2_ssd_kernel.routes``: the bf16
tensor-core kernel, "mma", and the f32 scalar kernel, "scalar"; and
``rrip_scan_flat.routes``: "short" and "chunked"). K8's bf16 route is two
CUDA kernels (a cumsum pre-pass and the scan) under one count; D2's chunked
route counts its two launches (speculate, fix-up). The counts change and
are read and reset under one lock (``_build.COUNT_LOCK``), so wrappers may
launch from several threads at once.
"""
from typing import Dict

from ._build import COUNT_LOCK

from .cache_scan import cache_scan_groups
from .decode_attention import decode_attention_kernel
from .dram_scan import dram_scan_chunked
from .embedding_bag import (
    embedding_bag_kernel,
    embedding_gather_kernel,
    vmem_gather_pool_kernel,
)
from .flash_attention import flash_attention_kernel
from .mamba2_ssd import mamba2_ssd_kernel
from .rrip_scan import rrip_scan_flat
from .stack_distance import stack_distance_groups

KERNELS = {
    "cache_scan": cache_scan_groups,
    "stack_distance": stack_distance_groups,
    "dram_scan": dram_scan_chunked,
    "rrip_scan": rrip_scan_flat,
    "embedding_bag": embedding_bag_kernel,
    "embedding_gather": embedding_gather_kernel,
    "vmem_gather_pool": vmem_gather_pool_kernel,
    "flash_attention": flash_attention_kernel,
    "decode_attention": decode_attention_kernel,
    "mamba2_ssd": mamba2_ssd_kernel,
}


def launch_counts() -> Dict[str, int]:
    with COUNT_LOCK:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0
        flash_attention_kernel.routes = dict.fromkeys(flash_attention_kernel.routes, 0)
        mamba2_ssd_kernel.routes = dict.fromkeys(mamba2_ssd_kernel.routes, 0)
        rrip_scan_flat.routes = dict.fromkeys(rrip_scan_flat.routes, 0)
