"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (``repro_torch`` is the program under test;
``repro`` is not); nothing reads the old ``benchmarks/`` folder; and the
harness refuses to run without a card or without the program."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke", "scripts", "tests"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "torch", "numpy", "bench"}, (path, tops)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bench\n"
        "for m in pkgutil.walk_packages(bench.__path__, 'bench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "import bench.run\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'})\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "rmc2_rank_reuse_high", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "rmc2_rank_reuse_high",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""
