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


# What a source of each design must contain: for wgmma+tma its Hopper
# helpers, TMA loads, wgmma products and the consumers' register hand-over;
# for mma.sync-3xtf32 the fp32 helpers, the 3xTF32 product and cp.async
# tile copies; for mma.sync-3xtf32-ring the shared split-once helpers of
# flash_fp32.cuh (the producer's split into B planes, `store_b_planes` or
# its step `store_b_step`; a warp's A planes; the 3xTF32 products that read
# the planes; the split of a computed tile), the mbarrier ring,
# the partner warps' named barriers and the register hand-over.
DESIGN_REQUIRES = {
    "wgmma+tma": ('#include "sm90_common.cuh"', "tma_load_4d", "wgmma_", "reg_alloc"),
    "mma.sync-3xtf32": ('#include "flash_fp32.cuh"', "mma3(", "load_rows_f32", "cp_wait"),
    "mma.sync-3xtf32-ring": ('#include "flash_fp32.cuh"', '#include "sm90_common.cuh"',
                             "store_b_", "stage_a_planes<", "mma3_nk<", "mma3_kn<",
                             "c_to_a_tf32(", "mbar_wait(", "named_bar_sync(", "reg_alloc"),
}
# The helpers that split an operand as they load it from a row-major tile:
# the ring design splits each element once instead.
SPLIT_AS_LOADED = ("load_a(", "load_b_nk(", "load_b_kn(", "mma3_add(", "load_rows_f32", "cp_wait")


@pytest.mark.parametrize("src", kernels.SOURCES)
def test_each_source_names_its_design(src):
    design = kernels.DESIGN[src]
    text = (kernels.CSRC / src).read_text()
    for token in DESIGN_REQUIRES[design]:
        assert token in text, (src, design, token)
    if design == "wgmma+tma":
        # The wgmma kernels fall back on no pre-Hopper instruction.
        assert "mma.sync" not in text and "ldmatrix" not in text and "cp.async." not in text
        # Each is instantiated for bf16 and fp16, with a C entry point each.
        assert "<flash::bf16>" in text and "<flash::f16>" in text
        assert "_bf16(" in text and "_fp16(" in text
    else:
        # The fp32 kernels run no product outside the 3xTF32 split.
        assert "wgmma" not in text and "mma_tf32(" not in text and "_fp32(" in text
    if design == "mma.sync-3xtf32-ring":
        assert not [h for h in SPLIT_AS_LOADED if h in text]
    assert set(kernels.DESIGN) == set(kernels.SOURCES)
    assert set(kernels.DESIGN.values()) == set(kernels.DESIGN_SASS)


RING_SOURCES = [src for src, d in kernels.DESIGN.items() if d == "mma.sync-3xtf32-ring"]


@pytest.mark.parametrize("src", RING_SOURCES)
def test_ring_sources_meet_the_block_once(src):
    """A ring kernel's block meets at one __syncthreads, the one after the
    mbarriers' initialisation: in their loops the producer and the
    consumers wait on the ring's mbarriers and the partners on their named
    barriers alone."""
    code = "\n".join(line.split("//", 1)[0] for line in
                     (kernels.CSRC / src).read_text().splitlines())
    assert code.count("__syncthreads()") == 1
    assert 0 < code.index("__syncthreads()") - code.index("mbar_init_fence()") < 40


def test_fp32_designs():
    """The fp32 forward keeps the split-as-loaded design; dq and dk/dv are
    the ring design, held to its TF32 products and its mbarriers."""
    assert {src: d for src, d in kernels.DESIGN.items() if src.endswith("_fp32.cu")} == {
        "flash_fwd_fp32.cu": "mma.sync-3xtf32",
        "flash_bwd_dq_fp32.cu": "mma.sync-3xtf32-ring",
        "flash_bwd_dkv_fp32.cu": "mma.sync-3xtf32-ring",
    }
    assert kernels.DESIGN_SASS["mma.sync-3xtf32-ring"] == ("HMMA.TF32", "SYNCS")


def test_every_entry_point_has_a_library():
    """Each kernel has a C entry point per type, in the wgmma source for
    bf16 and fp16 and in its fp32 source for fp32."""
    for name, src in kernels._LIB_OF.items():
        assert src in kernels.SOURCES and f'extern "C" int {name}(' in (
            kernels.CSRC / src).read_text(), name
    assert set(kernels._LIB_OF) == set(kernels._SIGNATURES)
    assert len(kernels._SIGNATURES) == 3 * len(kernels.TYPES)


def test_sass_counts_reads_cuobjdump(monkeypatch, tmp_path):
    sass = {
        "a.so": "  /*0100*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
                "  /*0110*/  UTMALDG.4D [UR8], [UR10] ;\n"
                "  /*0120*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR6], R24 ;\n",
        "b.so": "  /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n",
        "c.so": "  /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
                "  /*0110*/  HMMA.1688.F32.TF32 R4, R16, R12, R4 ;\n"
                "  /*0120*/  SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R41+URZ+0x32200], R34 ;\n",
    }
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(tmp_path / "bin" / "nvcc"))

    def fake_run(cmd, **kwargs):
        assert cmd[0] == str(tmp_path / "bin" / "cuobjdump") and cmd[1] == "-sass"
        return subprocess.CompletedProcess(cmd, 0, stdout=sass[cmd[2]], stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    counts = kernels.sass_counts({"fwd.cu": "a.so", "dq.cu": "b.so", "fp32.cu": "c.so"})
    assert counts == {"fwd.cu": {"HGMMA": 2, "UTMALDG": 1, "HMMA.TF32": 0, "SYNCS": 0},
                      "dq.cu": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 0, "SYNCS": 0},
                      "fp32.cu": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 2, "SYNCS": 1}}


def test_kernel_sass_counts_splits_by_function(monkeypatch, tmp_path):
    """Per-kernel counts from cuobjdump's "Function :" sections: an
    instantiation without wgmma or TMA shows as its own zero row."""
    sass = ("\tcode for sm_90a\n"
            "\t\tFunction : _ZN5flash10fwd_kernelILi256ELb1EEEv\n"
            "  /*0100*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
            "  /*0110*/  UTMALDG.4D [UR8], [UR10] ;\n"
            "  /*0120*/  UTMALDG.4D [UR8], [UR12] ;\n"
            "\t\tFunction : _ZN5flash10fwd_kernelILi64ELb1EEEv\n"
            "  /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(tmp_path / "bin" / "nvcc"))
    monkeypatch.setattr(kernels.subprocess, "run", lambda cmd, **kwargs:
                        subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr=""))
    per_kernel = kernels.kernel_sass_counts({"flash_fwd.cu": "a.so"})
    assert per_kernel == {"flash_fwd.cu": {
        "_ZN5flash10fwd_kernelILi256ELb1EEEv": {"HGMMA": 1, "UTMALDG": 2, "HMMA.TF32": 0,
                                                "SYNCS": 0},
        "_ZN5flash10fwd_kernelILi64ELb1EEEv": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 0,
                                               "SYNCS": 0}}}
    # The instantiation of another form fails its source's design.
    assert kernels.missing_sass(per_kernel) == {
        "flash_fwd.cu": ["_ZN5flash10fwd_kernelILi64ELb1EEEv"]}


def test_missing_sass_holds_each_design_to_its_instructions():
    tf32 = {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 24}
    wgmma = {"HGMMA": 8, "UTMALDG": 4, "HMMA.TF32": 0}
    assert kernels.missing_sass({"flash_fwd_fp32.cu": {"_ZN5flash14fwd_f32_kernelILi64E": tf32},
                                 "flash_fwd.cu": {"_ZN5flash10fwd_kernelI6__half": wgmma}}) == {}
    # The ring design needs its mbarriers beside its TF32 products.
    dkv = "_ZN5flash18bwd_dkv_f32_kernelI"
    ring = dict(tf32, SYNCS=10)
    assert kernels.missing_sass({"flash_bwd_dkv_fp32.cu": {dkv: ring}}) == {}
    no_ring = dict(tf32, SYNCS=0)
    assert kernels.missing_sass({"flash_bwd_dkv_fp32.cu": {dkv: no_ring}}) == {
        "flash_bwd_dkv_fp32.cu": [dkv]}
    # A wgmma kernel in an fp32 source, or a source without kernels, fails.
    assert kernels.missing_sass({"flash_fwd_fp32.cu": {"_ZN5flash14fwd_f32_kernelI": wgmma},
                                 "flash_fwd.cu": {}}) == {
        "flash_fwd_fp32.cu": ["_ZN5flash14fwd_f32_kernelI"], "flash_fwd.cu": ["no kernel"]}
