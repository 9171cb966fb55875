"""The kernel library's name follows every file under ``csrc/``, so an
edited source or header is rebuilt and a stale library never loads.  No
``nvcc`` is needed: only the name is computed."""

import shutil

import pytest

from distributed_learning_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return copy


@pytest.mark.parametrize("name", ["flash_params.cuh", "sm90.cuh", "flash_attention.cu",
                                  "flash_attention_sm90.cu"])
def test_editing_any_source_or_header_renames_the_library(csrc_copy, name):
    before = _build.library_path()
    assert before.parent == csrc_copy.parent / "_build"
    assert _build.library_path() == before  # the name is a function of the files
    path = csrc_copy / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_a_file_that_is_no_source_leaves_the_name(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "notes.txt").write_text("not compiled")
    assert _build.library_path() == before


def test_one_nvcc_per_source():
    sources = [p.name for p in _build._sources() if p.suffix == ".cu"]
    assert sources == ["flash_attention.cu", "flash_attention_sm90.cu"]
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
