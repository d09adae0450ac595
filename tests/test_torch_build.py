"""The kernel build's cache key (jdeflate_tpu_torch/ops/_cuda.py::_so_path).

A library's file name holds a hash of its CUDA source and of every csrc
header the source includes, directly or through another header, so an
edited header rebuilds each kernel that includes it, and only those. Runs on
a copy of csrc/; nothing is compiled."""
import shutil

from jdeflate_tpu_torch.ops import _cuda

SHARED = "tile_resolve.cuh"
USERS = ("expand", "expand1", "expand5resolve")
OTHERS = ("walk", "lz77walk", "expand5seed")


def _copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    monkeypatch.setattr(_cuda, "CSRC", str(src))
    return src


def _paths():
    return {n: _cuda._so_path(n) for n in USERS + OTHERS}


def test_so_path_follows_an_edited_header(tmp_path, monkeypatch):
    src = _copy(tmp_path, monkeypatch)
    before = _paths()
    assert len(set(before.values())) == len(before)
    hdr = src / SHARED
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = _paths()
    for n in USERS:
        assert after[n] != before[n], n
    for n in OTHERS:
        assert after[n] == before[n], n
    # the source itself still counts, and the key is stable
    cu = src / "expand1.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _cuda._so_path("expand1") != after["expand1"]
    assert _cuda._so_path("expand") == after["expand"]


def test_so_path_follows_nested_headers(tmp_path, monkeypatch):
    src = _copy(tmp_path, monkeypatch)
    (src / "inner.cuh").write_text("#pragma once\nconstexpr int kA = 1;\n")
    (src / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (src / "probe.cu").write_text('#include <cstdint>\n#include "outer.cuh"\n'
                                  '#include "outer.cuh"\n')
    first = _cuda._so_path("probe")
    (src / "inner.cuh").write_text("#pragma once\nconstexpr int kA = 2;\n")
    second = _cuda._so_path("probe")
    assert second != first
    # a header nobody includes does not count
    (src / "unused.cuh").write_text("// nothing\n")
    assert _cuda._so_path("probe") == second
