"""The port's kernel build helper: what names a built library.

``_build.library_path`` names each library by a hash of its source, the
``csrc/`` headers it includes and the compiler flags, so a library already
in ``build/`` is rebuilt when any of them changes. Runs without ``nvcc``.
"""
import pytest

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
