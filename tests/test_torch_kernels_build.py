"""The kernel loader's bookkeeping, on the CPU (no nvcc, no card).

Every CUDA file under trainer/csrc is compiled or hashed: a source missing
from kernels.SOURCES would never be built, and a header missing from
kernels.HEADERS would leave its edits out of the build tag, so a stale
library would be served after the edit. Each source names its design, which
chip_smoke.py holds against the SASS of the built library.
"""

import shutil
import subprocess

import pytest

from training_operator_tpu_torch.trainer import kernels

CUDA_FILES = sorted(p.name for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@pytest.mark.parametrize("name", CUDA_FILES)
def test_every_cuda_file_is_built_or_hashed(name):
    assert name in (kernels.SOURCES if name.endswith(".cu") else kernels.HEADERS)


def test_listed_files_exist():
    for name in (*kernels.SOURCES, *kernels.HEADERS):
        assert (kernels.CSRC / name).is_file(), name


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", [*kernels.HEADERS, *kernels.SOURCES])
def test_tag_changes_with_each_listed_file(csrc_copy, name):
    before = kernels._tag()
    assert kernels._tag() == before  # a pure function of the bytes
    path = csrc_copy / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert kernels._tag() != before


def test_tag_ignores_unlisted_files(csrc_copy):
    before = kernels._tag()
    (csrc_copy / "notes.txt").write_text("not part of the build")
    assert kernels._tag() == before


# What a source of each design must contain: its Hopper helpers, TMA loads,
# wgmma products and the consumers' register hand-over.
DESIGN_REQUIRES = {
    "wgmma+tma": ('#include "sm90_common.cuh"', "tma_load_4d", "wgmma_", "reg_alloc"),
}


@pytest.mark.parametrize("src", kernels.SOURCES)
def test_each_source_names_its_design(src):
    design = kernels.DESIGN[src]
    text = (kernels.CSRC / src).read_text()
    for token in DESIGN_REQUIRES[design]:
        assert token in text, (src, design, token)
    # No source falls back to the pre-Hopper instructions.
    assert "mma.sync" not in text and "ldmatrix" not in text and "cp.async." not in text
    assert set(kernels.DESIGN) == set(kernels.SOURCES)


def test_sass_counts_reads_cuobjdump(monkeypatch, tmp_path):
    sass = {
        "a.so": "  /*0100*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
                "  /*0110*/  UTMALDG.4D [UR8], [UR10] ;\n"
                "  /*0120*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR6], R24 ;\n",
        "b.so": "  /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n",
    }
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(tmp_path / "bin" / "nvcc"))

    def fake_run(cmd, **kwargs):
        assert cmd[0] == str(tmp_path / "bin" / "cuobjdump") and cmd[1] == "-sass"
        return subprocess.CompletedProcess(cmd, 0, stdout=sass[cmd[2]], stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    counts = kernels.sass_counts({"fwd.cu": "a.so", "dq.cu": "b.so"})
    assert counts == {"fwd.cu": {"HGMMA": 2, "UTMALDG": 1},
                      "dq.cu": {"HGMMA": 0, "UTMALDG": 0}}
