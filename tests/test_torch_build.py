"""The port's kernel build helper: what names a built library.

``_build.library_path`` names each library by a hash of its source, the
``csrc/`` headers it includes and the compiler flags, so a library already
in ``build/`` is rebuilt when any of them changes; threads that reach
their first launch together build each source once; the input checks take
tensors on any one device; launch counts add up across threads. Runs
without ``nvcc`` or a card.
"""
import sys
import threading

import pytest
import torch

from repro_torch.kernels import _build


def test_scan_sources_share_the_set_team_walk():
    k1, k2 = _build.source_text("cache_scan"), _build.source_text("stack_distance")
    for text in (k1, k2):
        assert '#include "set_team_scan.cuh"' not in text
        assert "walk_row" in text and "#pragma once" not in text
    assert "struct CacheStep" in k1 and "struct RankStep" in k2


@pytest.mark.parametrize("edit", ["header", "source", "nothing"])
def test_library_path_follows_the_source_and_its_headers(tmp_path, monkeypatch, edit):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "walk.cuh").write_text("#pragma once\nint walk() { return 1; }\n")
    (tmp_path / "a.cu").write_text('#include "walk.cuh"\nint a() { return walk(); }\n')
    (tmp_path / "b.cu").write_text("int b() { return 2; }\n")
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert _build.source_text("a").count("int walk()") == 1
    if edit == "header":
        (tmp_path / "walk.cuh").write_text("#pragma once\nint walk() { return 3; }\n")
    elif edit == "source":
        (tmp_path / "a.cu").write_text('#include "walk.cuh"\nint a() { return -walk(); }\n')
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert (after["a"] != before["a"]) == (edit != "nothing")
    assert after["b"] == before["b"]


def test_a_header_included_twice_is_inlined_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "h.cuh").write_text("#pragma once\nint h = 1;\n")
    (tmp_path / "g.cuh").write_text('#pragma once\n#include "h.cuh"\nint g = 2;\n')
    (tmp_path / "c.cu").write_text('#include "h.cuh"\n#include "g.cuh"\nint c = 3;\n')
    assert _build.source_text("c").split() == ["int", "h", "=", "1;", "int", "g", "=", "2;",
                                               "int", "c", "=", "3;"]


FAKE_NVCC = """#!/usr/bin/env python3
import pathlib, sys, time
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
with open(out.parent / "calls.log", "a") as log:
    log.write(pathlib.Path(args[-1]).stem + "\\n")
time.sleep(0.2)
out.write_bytes(b"library")
print("ptxas info    : Used 8 registers")
"""


def test_threads_that_launch_at_once_build_each_source_once(tmp_path, monkeypatch):
    """Four threads reach their first launch together: one ``nvcc`` per
    source runs, every thread gets the libraries, no temporary is left."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"int {name}() {{ return 1; }}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("#!/usr/bin/env python3", f"#!{sys.executable}"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "SOURCES", ("a", "b", "c"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    start, results, errors = threading.Barrier(4), [], []

    def first_launch():
        start.wait()
        try:
            results.append(_build.build_all())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=first_launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert sorted((build / "calls.log").read_text().split()) == ["a", "b", "c"]
    assert all(r == results[0] for r in results) and len(results) == 4
    assert all(p.read_bytes() == b"library" for p in results[0].values())
    assert not [p.name for p in build.iterdir() if ".tmp" in p.name]


class _Stand:
    """What ``check_tensors`` reads of a tensor, on any device (no card)."""

    def __init__(self, device, dtype=torch.int32):
        self.device, self.dtype = torch.device(device), dtype

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("device", ["cpu", "cuda:0", "cuda:1", "cuda:7"])
def test_check_tensors_takes_any_one_device(device):
    _build.check_tensors("k", (_Stand(device), torch.int32), (_Stand(device, torch.bool),
                                                              torch.bool))


@pytest.mark.parametrize("a,b", [("cuda:0", "cuda:1"), ("cpu", "cuda:1"), ("cuda:1", "cpu")])
def test_check_tensors_refuses_mixed_devices(a, b):
    with pytest.raises(ValueError, match="tensors on"):
        _build.check_tensors("k", (_Stand(a), torch.int32), (_Stand(b), torch.int32))


def test_check_tensors_refuses_other_device_types_and_dtypes():
    with pytest.raises(ValueError, match="unsupported device"):
        _build.check_tensors("k", (_Stand("meta"), torch.int32))
    with pytest.raises(TypeError, match="expected"):
        _build.check_tensors("k", (_Stand("cuda:1", torch.int64), torch.int32))


def test_launch_counts_from_threads_add_up():
    from repro_torch import kernels as K

    fn = K.KERNELS["rrip_scan"]
    K.reset_launch_counts()

    def launch_many():
        for _ in range(2000):
            _build.count_launch(fn, 2, route="chunked")
            _build.count_launch(fn, 1, route="short")

    threads = [threading.Thread(target=launch_many) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert K.launch_counts()["rrip_scan"] == 6 * 2000 * 3
    assert fn.routes == {"short": 6 * 2000, "chunked": 6 * 2000 * 2}
    K.reset_launch_counts()
    assert K.launch_counts()["rrip_scan"] == 0 and fn.routes == {"short": 0, "chunked": 0}
    with _build.on_device(torch.device("cpu")):
        pass
