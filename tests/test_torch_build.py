"""The kernel build's cache key (wire_tpu_torch/ops/build.py): the hashed
library path of csrc/<name>.cu changes when the source, a shared
csrc/*.cuh header or the flags change, and only then.  Hashing needs no
nvcc, so this runs on the CPU on a copy of csrc/."""
import os
import shutil

import pytest

from wire_tpu_torch.ops import build

SOURCES = ("wire_step", "wire_mlp", "rotsum", "line_sample", "real_mlp",
           "mscale2_step", "mfn", "wire2d")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, d)
    monkeypatch.setattr(build, "CSRC_DIR", str(d))
    return d


def test_every_kernel_source_is_there():
    for name in SOURCES:
        assert os.path.isfile(os.path.join(build.CSRC_DIR, f"{name}.cu"))
    for header in ("wire_gemm.cuh", "gemm_common.cuh", "real_chain.cuh",
                   "wire_tc.cuh"):
        assert os.path.isfile(os.path.join(build.CSRC_DIR, header))


@pytest.mark.parametrize("header", ["wire_gemm.cuh", "gemm_common.cuh",
                                    "wire_tc.cuh", "real_chain.cuh"])
@pytest.mark.parametrize("name", SOURCES)
def test_library_path_follows_the_shared_header(csrc, name, header):
    before = build.library_path(name)
    assert before == build.library_path(name)
    assert os.path.basename(before).startswith(f"{name}-")
    header = csrc / header
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before


def test_library_path_follows_source_and_flags(csrc, monkeypatch):
    others = {n: build.library_path(n) for n in SOURCES}
    src = csrc / "rotsum.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("rotsum") != others["rotsum"]
    for n in ("wire_step", "wire_mlp", "line_sample", "real_mlp"):
        assert build.library_path(n) == others[n]
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("line_sample") != others["line_sample"]


def test_a_new_header_rebuilds(csrc):
    before = build.library_path("wire_mlp")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("wire_mlp") != before
