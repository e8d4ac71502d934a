"""The port's kernel build: libraries are named by a hash of the source,
of every header in csrc/ and of the flags, so an edited shared header
(csrc/dropout_hash.cuh, included by both attention kernels) rebuilds both.
Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from act3d_tpu_torch.kernels import _build


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert set(_build.SOURCES) <= {p.name for p in csrc.glob("*.cu")}
    before = {s: _build.library_path(s) for s in _build.SOURCES}
    assert {s: _build.library_path(s) for s in _build.SOURCES} == before

    header = csrc / "dropout_hash.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in _build.SOURCES}
    for s in _build.SOURCES:
        assert after[s] != before[s], s
        assert after[s].parent == _build.BUILD_DIR and after[s].name.endswith(".so")

    source = csrc / _build.SOURCES[0]
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path(_build.SOURCES[0]) != after[_build.SOURCES[0]]
    assert _build.library_path(_build.SOURCES[1]) == after[_build.SOURCES[1]]

    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path(_build.SOURCES[1]) != after[_build.SOURCES[1]]


def test_build_without_nvcc_raises_before_writing_a_library(tmp_path, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))
