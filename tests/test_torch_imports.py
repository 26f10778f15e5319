"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback when the card is missing."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_every_port_module_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        sys.modules["jax"] = None

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError(f"the port imported {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import repro_torch
        names = ["repro_torch"]
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            names.append(m.name)
            importlib.import_module(m.name)
        assert not any(n == "jax" or n.startswith(("jax.", "repro.")) or n == "repro"
                       for n, mod in sys.modules.items() if mod is not None)
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    for sub in ("models", "models.dlrm", "models.layers", "data", "data.dlrm_data",
                "kernels.embedding_bag", "kernels.ops", "kernels.ref", "kernels.flash_attention",
                "kernels.decode_attention", "kernels.mamba2_ssd", "models.config",
                "models.registry", "models.transformer", "models.mamba", "models.hybrid",
                "configs.zamba2_2p7b", "data.lm", "serving.engine", "launch.serve",
                "core.sweep", "core.sweep_ckpt", "core.search", "core.faults",
                "distributed", "distributed.sweep_shard", "core.lm_mapper",
                "core.requests", "serving.scheduler", "core.oracle", "core.memory.golden",
                "core.memory.golden_dram", "models.whisper", "configs.deepseek_v2_lite_16b",
                "configs.arctic_480b", "configs.chameleon_34b", "configs.granite_34b",
                "configs.granite_20b", "configs.whisper_base"):
        assert f"repro_torch.{sub}" in names, sub


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_sources_do_not_import_jax_or_repro(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_forbidden_import_pattern_matches_what_it_must():
    for bad in ("import jax", "from jax import numpy", "import repro",
                "from repro.core import simulate", "    import repro.core"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import simulate",
               "from .core import simulate"):
        assert not _FORBIDDEN.search(ok), ok


def test_simulate_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = dlrm_rmc2_small(num_tables=1, rows_per_table=50, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate(wl, tpuv6e())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()


def test_resolve_device_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_kernel_libraries_are_named_by_source_hash():
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert len(set(paths.values())) == len(_build.SOURCES)
    assert all((_build.CSRC / f"{name}.cu").exists() for name in _build.SOURCES)
