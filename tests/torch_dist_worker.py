"""Worker processes of the multi-rank CPU tests (``gloo``): importable by
the processes ``multiprocessing`` spawns, without JAX."""
import numpy as np
import torch
import torch.distributed as dist


def start(rank: int, world: int, store_path: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)


def matmul_inputs(world: int, seed: int = 0):
    """x (8, 16 n) and w (16 n, 4 n) f32, the same on every rank."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 16 * world)).astype(np.float32),
            rng.standard_normal((16 * world, 4 * world)).astype(np.float32))


def collective_matmul(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """Each rank's ``ring_matmul`` and ``psum_matmul`` of its K-shards."""
    from repro_torch.distributed.collective_matmul import psum_matmul, ring_matmul

    start(rank, world, store_path)
    try:
        x, w = matmul_inputs(world)
        k = slice(16 * rank, 16 * (rank + 1))
        x_loc, w_loc = torch.from_numpy(x[:, k].copy()), torch.from_numpy(w[k].copy())
        out = torch.stack([ring_matmul(x_loc, w_loc), psum_matmul(x_loc, w_loc)])
        np.save(f"{out_dir}/rank{rank}.npy", out.numpy())
    finally:
        dist.destroy_process_group()
