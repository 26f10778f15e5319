"""K3, K4, K5: the embedding kernels and their plain torch versions.

Replace the three Pallas kernels of ``repro/kernels/embedding_bag.py``, the
paper's operation:

* ``embedding_bag_kernel`` (K3, ``_bag_kernel``): for each (b, t) bag,
  gather L rows of the stacked ``(T*R, D)`` table by pre-offset int32
  indices ``(B, T, L)``, sum them in f32 in l order, cast to the table
  dtype -> ``(B, T, D)``;
* ``embedding_gather_kernel`` (K4, ``_gather_kernel``): ``(N,)`` int32 ->
  ``(N, D)``, a row copy;
* ``vmem_gather_pool_kernel`` (K5, ``_vmem_pool_kernel``): the paper's
  Profiling (pinning) policy. The hot table ``(H, D)`` is held on chip:
  "VMEM" on the TPU is shared memory on Hopper. Per bag it sums
  ``mask * hot[pos]`` over l in f32, in l order, and casts.

Each wrapper launches its CUDA kernel (``csrc/embedding_bag.cu``) for CUDA
tensors and runs its plain version for CPU tensors; there is no other
route. Tables are f32 or bf16. An index (K5: a position) outside the table
reads, on both routes, the row the reference's gathers read: a negative
index counts from the end, and one still outside is clamped. The plain
versions add in the kernels' order, so kernel and plain version agree bit
for bit, except for a K5 hot table larger than one block's shared memory
(``vmem_tile_rows``): the kernel then sums tile by tile.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..device import indexed_device
from ._build import check_launch, check_tensors, count_launch, load_library, on_device

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def _check_table(name: str, table: torch.Tensor) -> None:
    if table.dim() != 2 or min(table.shape) < 1:
        raise ValueError(f"{name}: table must be (rows, D) with rows, D >= 1; "
                         f"got {tuple(table.shape)}")
    if table.dtype not in DTYPE_IDS:
        raise TypeError(f"{name}: table dtype must be float32 or bfloat16, got {table.dtype}")


def _rows(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows the reference's gathers read for ``idx``: a negative index
    counts from the end, then a row outside the table is clamped."""
    idx = idx.long()
    return torch.where(idx < 0, idx + rows, idx).clamp(0, rows - 1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "embedding_bag_launch": [_P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P, _P],
    "embedding_gather_launch": [_P, _P, _I64, _I64, _I, _I, _P, _P],
    "vmem_pool_tile_rows": [_I, ctypes.POINTER(ctypes.c_int)],
    "vmem_pool_prepare": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "vmem_gather_pool_launch": [_P, _P, _P, _I, _I64, _I, _I, _I, _I, _I, _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(load_library("embedding_bag"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _sm_count(device=None) -> int:
    """SMs of ``device`` (the current CUDA device when ``None``)."""
    return _sms(indexed_device("cuda" if device is None else device))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# K3: gather + sum-pool
# ---------------------------------------------------------------------------

def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``acc += table[indices[..., l]].float()`` for l in order; cast once."""
    B, T, L = indices.shape
    rows = _rows(indices, table.shape[0])
    acc = torch.zeros((B, T, table.shape[1]), dtype=torch.float32, device=table.device)
    for l in range(L):
        acc = acc + table[rows[..., l]].float()
    return acc.to(table.dtype)


def embedding_bag_kernel(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Sum-pool ``(B, T, D)`` of the rows ``indices`` (int32 ``(B, T, L)``,
    already offset by ``t * R``) of ``table`` ``(T*R, D)``.

    The CUDA kernel for CUDA tensors (one warp per bag, whole-row loads,
    the bags taken table by table so that a table's re-read rows stay in
    L2; see ``csrc/embedding_bag.cu``), ``embedding_bag_plain`` for CPU
    tensors. A failed build or launch raises.
    """
    _check_table("embedding_bag", table)
    if indices.dim() != 3:
        raise ValueError(f"embedding_bag: indices must be (B, T, L), got {tuple(indices.shape)}")
    check_tensors("embedding_bag", (table, table.dtype), (indices, torch.int32))
    if table.device.type == "cpu":
        return embedding_bag_plain(table, indices)
    B, T, L = indices.shape
    R, D = table.shape
    out = torch.empty((B, T, D), dtype=table.dtype, device=table.device)
    if B * T == 0:
        return out
    with on_device(table.device):
        err = _fn("embedding_bag_launch")(table.data_ptr(), indices.data_ptr(), R, B * T, T, L,
                                          D, DTYPE_IDS[table.dtype], _sm_count(table.device),
                                          out.data_ptr(), _stream(table))
    check_launch("embedding_bag", err)
    count_launch(embedding_bag_kernel)
    return out


embedding_bag_kernel.launches = 0


# ---------------------------------------------------------------------------
# K4: row gather
# ---------------------------------------------------------------------------

def embedding_gather_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` for int32 ``(N,)`` indices."""
    return table[_rows(indices, table.shape[0])]


def embedding_gather_kernel(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``table[indices]``, ``(N, D)``, for int32 ``(N,)`` indices.

    The CUDA kernel for CUDA tensors, ``embedding_gather_plain`` for CPU
    tensors. A failed build or launch raises.
    """
    _check_table("embedding_gather", table)
    if indices.dim() != 1:
        raise ValueError(f"embedding_gather: indices must be (N,), got {tuple(indices.shape)}")
    check_tensors("embedding_gather", (table, table.dtype), (indices, torch.int32))
    if table.device.type == "cpu":
        return embedding_gather_plain(table, indices)
    (N,) = indices.shape
    R, D = table.shape
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if N == 0:
        return out
    with on_device(table.device):
        err = _fn("embedding_gather_launch")(table.data_ptr(), indices.data_ptr(), R, N,
                                             D * table.element_size(), _sm_count(table.device),
                                             out.data_ptr(), _stream(table))
    check_launch("embedding_gather", err)
    count_launch(embedding_gather_kernel)
    return out


embedding_gather_kernel.launches = 0


# ---------------------------------------------------------------------------
# K5: hot table held on chip, masked gather + pool
# ---------------------------------------------------------------------------

def vmem_gather_pool_plain(hot_table: torch.Tensor, positions: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """``acc += mask[..., l].float() * hot_table[positions[..., l]].float()``
    for l in order; cast once."""
    B, T, L = positions.shape
    rows = _rows(positions, hot_table.shape[0])
    acc = torch.zeros((B, T, hot_table.shape[1]), dtype=torch.float32, device=hot_table.device)
    for l in range(L):
        acc = acc + mask[..., l, None].float() * hot_table[rows[..., l]].float()
    return acc.to(hot_table.dtype)


def vmem_tile_rows(row_bytes: int, device=None) -> int:
    """Rows of ``row_bytes`` that one block's shared memory holds on
    ``device`` (the current CUDA device when ``None``): K5 stages a larger
    hot table in tiles of this many rows."""
    return _tile_rows(int(row_bytes), indexed_device("cuda" if device is None else device))


@functools.lru_cache(maxsize=None)
def _tile_rows(row_bytes: int, device: torch.device) -> int:
    rows = ctypes.c_int(0)
    with on_device(device):
        check_launch("vmem_gather_pool (device query)",
                     _fn("vmem_pool_tile_rows")(row_bytes, ctypes.byref(rows)))
    return rows.value


@functools.lru_cache(maxsize=None)
def _pool_blocks(dtype_id: int, D: int, tile_rows: int, device: torch.device) -> int:
    """K5's shared-memory opt-in on ``device``, set once there, and the
    blocks of a tile of ``tile_rows x D`` that stay resident on it (the
    grid's cap)."""
    blocks = ctypes.c_int(0)
    with on_device(device):
        check_launch("vmem_gather_pool (set-up)",
                     _fn("vmem_pool_prepare")(dtype_id, D, tile_rows, ctypes.byref(blocks)))
    return blocks.value


def vmem_gather_pool_kernel(hot_table: torch.Tensor, positions: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Pooled hot contributions ``(B, T, D)``: per bag, the sum over l of
    ``mask * hot_table[positions]`` (int32 ``(B, T, L)`` each; mask 1 = hot).

    The CUDA kernel for CUDA tensors, ``vmem_gather_pool_plain`` for CPU
    tensors. A failed build or launch raises.
    """
    name = "vmem_gather_pool"
    _check_table(name, hot_table)
    if positions.dim() != 3 or positions.shape != mask.shape:
        raise ValueError(f"{name}: positions and mask must share one (B, T, L) shape; got "
                         f"{tuple(positions.shape)}, {tuple(mask.shape)}")
    check_tensors(name, (hot_table, hot_table.dtype), (positions, torch.int32),
                  (mask, torch.int32))
    if hot_table.device.type == "cpu":
        return vmem_gather_pool_plain(hot_table, positions, mask)
    B, T, L = positions.shape
    H, D = hot_table.shape
    dev = hot_table.device
    out = torch.empty((B, T, D), dtype=hot_table.dtype, device=dev)
    if B * T == 0:
        return out
    tile_rows = min(H, vmem_tile_rows(D * hot_table.element_size(), dev))
    if tile_rows < 1:
        raise ValueError(f"{name}: one row of {D} x {hot_table.element_size()} bytes exceeds "
                         "a block's shared memory")
    scratch = (torch.empty((B * T, D), dtype=torch.float32, device=dev)
               if tile_rows < H else None)
    dtype_id = DTYPE_IDS[hot_table.dtype]
    blocks = _pool_blocks(dtype_id, D, tile_rows, dev)
    with on_device(dev):
        err = _fn("vmem_gather_pool_launch")(
            hot_table.data_ptr(), positions.data_ptr(), mask.data_ptr(), H, B * T, L, D,
            tile_rows, blocks, dtype_id, None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), _stream(hot_table))
    check_launch(name, err)
    count_launch(vmem_gather_pool_kernel)
    return out


vmem_gather_pool_kernel.launches = 0
