"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` is a ``.cu`` file with a plain C launch function,
compiled for ``sm_90a`` into its own shared library; a source may include
headers of ``csrc/`` (``#include "name.cuh"``). All libraries are built
together (one ``nvcc`` per source, started at once) at the first launch of
any kernel, into ``build/kernels/`` at the repository root, named by a hash
of the source with its headers and the flags, so an unchanged source is
never rebuilt and an edited header rebuilds every source that includes it.
Nothing here runs at import time, so the package imports on machines without
``nvcc`` or a GPU.

Threads may launch kernels at once (the sharded sweep runs one worker
thread per shard): the build and the loading of the libraries happen under
one lock, so the first launches of several threads compile each source
once, and the wrappers count their launches through ``count_launch``, under
a lock of its own. A kernel launches on the device of its tensors, any CUDA
device: ``on_device`` makes it the thread's current device for the launch,
whose stream is that device's current stream of the thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from contextlib import nullcontext
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# latency_probe holds no kernel of the port: chip_smoke.py times its chains
# for the kernels' latency bounds.
SOURCES = ("cache_scan", "stack_distance", "dram_scan", "rrip_scan", "embedding_bag",
           "latency_probe", "flash_attention", "decode_attention", "mamba2_ssd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -fmad=false keeps every f32 add of the DRAM scan and every multiply-add of
# the hot-pinned pool two rounded operations (no contraction), which their
# bitwise equality with the reference and the plain versions relies on. The
# LM kernels (K6-K8) are held to a tolerance and keep fused multiply-adds.
_FUSED_MULTIPLY_ADD = frozenset(("flash_attention", "decode_attention", "mamba2_ssd"))


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + (() if name in _FUSED_MULTIPLY_ADD else ("-fmad=false",))


_loaded: Dict[str, ctypes.CDLL] = {}
# Held while libraries are built or loaded (re-entrant: load_library builds).
_BUILD_LOCK = threading.RLock()
# Held while a launch count changes or is reset.
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the port's CUDA kernels cannot be built"
        )
    return found


_INCLUDE = re.compile(r'^#include "([^"]+)"[^\n]*$', re.M)


def source_text(name: str) -> str:
    """``csrc/<name>.cu`` with each ``#include "..."`` of a ``csrc/`` header
    replaced by the header's text (each header once): what the compiler
    reads, as one file."""
    seen = set()

    def expand(text: str) -> str:
        def header(m):
            if m.group(1) in seen:
                return ""
            seen.add(m.group(1))
            return expand((CSRC / m.group(1)).read_text().replace("#pragma once\n", ""))
        return _INCLUDE.sub(header, text)

    return expand((CSRC / f"{name}.cu").read_text())


def library_path(name: str) -> Path:
    digest = hashlib.sha256((source_text(name) + " ".join(nvcc_flags(name))).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, in parallel.

    Returns ``{name: library path}``. Raises ``RuntimeError`` with the
    compiler's output when a source fails to build. The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``. Threads that call it at once wait for one build.
    """
    with _BUILD_LOCK:
        return _build_all()


def _build_all() -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed to build " + "\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building all kernels if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


def count_launch(fn, n: int = 1, route: str = None) -> None:
    """Add ``n`` to a wrapper's ``launches`` (and to ``routes[route]``)."""
    with COUNT_LOCK:
        fn.launches += n
        if route is not None:
            fn.routes[route] += n


def on_device(device: torch.device):
    """Context in which a launch on ``device`` runs: that CUDA device made
    the thread's current one (the C launchers start their kernels on the
    current device); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def check_rows(name: str, sets, tags, valid) -> None:
    """Validate the ``(B, L)`` row inputs of the cache kernels."""
    if sets.dim() != 2 or sets.shape != tags.shape or sets.shape != valid.shape:
        raise ValueError(
            f"{name}: sets, tags and valid must share one (B, L) shape; got "
            f"{tuple(sets.shape)}, {tuple(tags.shape)}, {tuple(valid.shape)}")
    check_tensors(name, (sets, torch.int32), (tags, torch.int32), (valid, torch.bool))


def check_tensors(name: str, *pairs) -> None:
    """Each ``(tensor, dtype)`` pair: that dtype, contiguous, one device
    (the CPU or any CUDA device)."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def check_launch(name: str, err: int) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
