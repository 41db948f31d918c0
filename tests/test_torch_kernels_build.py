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
# for mma.sync-3xtf32-ring the shared split-once helpers of flash_fp32.cuh
# (the producer's split into B planes, `store_b_planes` or its step
# `store_b_step`; a warp's A planes; the 3xTF32 products that read the
# planes; the split of a computed tile), the mbarrier ring, the partner
# warps' named barriers and the register hand-over; for
# mma.sync-3xtf32-stream the 3xTF32 product, q staged once in A planes, K
# and V copied by cp.async into an mbarrier ring, the group's named
# barriers and the register hand-over; for wgmma-3xtf32+tma (the head's
# products) TMA loads through the mbarrier ring, the tf32 split, the tf32
# wgmma, the proxy fence before wgmma reads the split planes, and the
# register hand-over; for multi-tensor-stream (clip and AdamW) the table's
# rows found by binary search, float4 accesses, 64-bit offsets, a
# fixed-order block sum and IEEE division and square root; for
# warp-row-permute (the expert layer's permutation) 16-byte row accesses,
# a warp's butterfly sum, the padding rows found by ballot, 64-bit row
# offsets and bf16 rounding to nearest even.
DESIGN_REQUIRES = {
    "wgmma+tma": ('#include "sm90_common.cuh"', "tma_load_4d", "wgmma_", "reg_alloc"),
    "wgmma-3xtf32+tma": ('#include "flash_fp32.cuh"', '#include "sm90_common.cuh"',
                         "tma_load_2d(", "mbar_wait(", "split_tf32(", "wgmma_tf32_",
                         "fence.proxy.async", "reg_alloc"),
    "mma.sync-3xtf32-ring": ('#include "flash_fp32.cuh"', '#include "sm90_common.cuh"',
                             "store_b_", "stage_a_planes<", "mma3_nk<", "mma3_kn<",
                             "c_to_a_tf32(", "mbar_wait(", "named_bar_sync(", "reg_alloc"),
    "mma.sync-3xtf32-stream": ('#include "flash_fp32.cuh"', '#include "sm90_common.cuh"',
                               "mma3(", "stage_a_planes<", "c_to_a_tf32(", "cp_async_arrive(",
                               "mbar_wait(", "named_bar_sync(", "reg_alloc"),
    "multi-tensor-stream": ("struct Tensor", "tensor_of(", "float4", "long long",
                            "block_sum(", "__fdiv_rn(", "__fsqrt_rn("),
    "warp-row-permute": ("uint4", "__ldg(", "__shfl_xor_sync(", "__ballot_sync(", "long long",
                         "__floats2bfloat162_rn(", "__float2bfloat16_rn("),
}
# The helpers that split an operand as they load it from a row-major tile:
# the ring design splits each element once instead.
SPLIT_AS_LOADED = ("load_a(", "load_b_nk(", "load_b_kn(", "mma3_add(", "load_rows_f32", "cp_wait")
# What each fp32 design must not contain: the ring none of the split-as-loaded
# helpers; the stream design splits K and V as it reads them, but loads q
# once per block (no per-tile A loads) and waits on no cp.async group.
DESIGN_FORBIDS = {
    "wgmma+tma": (),
    "wgmma-3xtf32+tma": ("mma_tf32(", "mma3(", "mma3_nk<", "mma3_kn<"),
    "mma.sync-3xtf32-ring": SPLIT_AS_LOADED,
    "mma.sync-3xtf32-stream": ("load_a(", "load_rows_f32", "cp_wait"),
    # No atomics (the norm is summed in a fixed order) and no fast-math
    # division, square root or reciprocal.
    "multi-tensor-stream": ("atomicAdd", "atomicCAS", "__fdividef", "rsqrtf", "__frsqrt_rn",
                            "sqrtf("),
    # One writer a row and fixed-order sums: no atomics; no fill of the
    # whole buffer (cudaMemsetAsync only on the byte map of named rows).
    "warp-row-permute": ("atomicAdd", "atomicCAS", "atomicExch", "red.global", "__syncthreads",
                         "cudaMemset("),
}


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
    elif design == "wgmma-3xtf32+tma":
        # fp32 operands in the 3xTF32 split on wgmma: three products a k step.
        assert "m64n128k8.f32.tf32.tf32" in text and "_fp32(" in text
        assert "mma.sync." not in text and "ldmatrix" not in text
    elif design == "multi-tensor-stream":
        # A stream of fp32 elements: no products, one launch a pass.
        assert "mma" not in text and "_fp32(" in text
    elif design == "warp-row-permute":
        # bf16 rows moved and summed: no products, entry points per type.
        assert "mma" not in text and "_bf16(" in text
    else:
        # The fp32 kernels run no product outside the 3xTF32 split.
        assert "wgmma" not in text and "mma_tf32(" not in text and "_fp32(" in text
    assert not [h for h in DESIGN_FORBIDS[design] if h in text]
    assert set(kernels.DESIGN) == set(kernels.SOURCES)
    assert set(kernels.DESIGN.values()) == set(kernels.DESIGN_SASS) == set(DESIGN_REQUIRES)


RING_SOURCES = [src for src, d in kernels.DESIGN.items()
                if d in ("mma.sync-3xtf32-ring", "mma.sync-3xtf32-stream")]


@pytest.mark.parametrize("src", RING_SOURCES)
def test_ring_sources_meet_the_block_once(src):
    """A ring kernel's block (the ring and the stream designs) meets at one
    __syncthreads, the one after the mbarriers' initialisation: in their
    loops the producer and the consumers wait on the ring's mbarriers and
    the partners or groups on their named barriers alone."""
    code = "\n".join(line.split("//", 1)[0] for line in
                     (kernels.CSRC / src).read_text().splitlines())
    assert code.count("__syncthreads()") == 1
    assert 0 < code.index("__syncthreads()") - code.index("mbar_init_fence()") < 40


def test_fp32_designs():
    """The fp32 flash forward is the stream design; dq and dk/dv are the
    ring design; both are held to their TF32 products and their mbarriers.
    The head's fp32 products are wgmma-3xtf32+tma, held to wgmma and TMA;
    clip and AdamW are multi-tensor-stream, held to 128-bit loads and
    stores."""
    assert {src: d for src, d in kernels.DESIGN.items() if src.endswith("_fp32.cu")} == {
        "flash_fwd_fp32.cu": "mma.sync-3xtf32-stream",
        "flash_bwd_dq_fp32.cu": "mma.sync-3xtf32-ring",
        "flash_bwd_dkv_fp32.cu": "mma.sync-3xtf32-ring",
        "head_gemm_fp32.cu": "wgmma-3xtf32+tma",
        "adamw_fp32.cu": "multi-tensor-stream",
    }
    assert kernels.DESIGN_SASS["wgmma-3xtf32+tma"] == ("HGMMA", "UTMALDG")
    assert kernels.DESIGN_SASS["multi-tensor-stream"] == ("LDG.128", "STG.128")
    assert kernels.DESIGN_SASS["mma.sync-3xtf32-ring"] == ("HMMA.TF32", "SYNCS")
    assert kernels.DESIGN_SASS["mma.sync-3xtf32-stream"] == ("HMMA.TF32", "SYNCS")


def test_every_entry_point_has_a_library():
    """Each flash kernel has a C entry point per type, in the wgmma source
    for bf16 and fp16 and in its fp32 source for fp32; the head's three
    products have theirs in head_gemm_fp32.cu, clip and AdamW theirs in
    adamw_fp32.cu, the expert layer's permutation its two in
    moe_permute.cu."""
    for name, src in kernels._LIB_OF.items():
        assert src in kernels.SOURCES and f'extern "C" int {name}(' in (
            kernels.CSRC / src).read_text(), name
    assert set(kernels._LIB_OF) == set(kernels._SIGNATURES)
    assert len(kernels._SIGNATURES) == (3 * len(kernels.TYPES) + len(kernels.HEAD_ENTRIES)
                                        + len(kernels.ADAMW_SIGNATURES)
                                        + len(kernels.PERMUTE_SIGNATURES))
    assert {kernels._LIB_OF[name] for name in kernels.HEAD_ENTRIES} == {"head_gemm_fp32.cu"}
    assert {kernels._LIB_OF[name] for name in kernels.ADAMW_SIGNATURES} == {"adamw_fp32.cu"}
    assert {kernels._LIB_OF[name] for name in kernels.PERMUTE_SIGNATURES} == {"moe_permute.cu"}


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
    none = {"LDG.128": 0, "STG.128": 0}
    assert counts == {"fwd.cu": {"HGMMA": 2, "UTMALDG": 1, "HMMA.TF32": 0, "SYNCS": 0, **none},
                      "dq.cu": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 0, "SYNCS": 0, **none},
                      "fp32.cu": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 2, "SYNCS": 1,
                                  **none}}


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
    none = {"LDG.128": 0, "STG.128": 0}
    assert per_kernel == {"flash_fwd.cu": {
        "_ZN5flash10fwd_kernelILi256ELb1EEEv": {"HGMMA": 1, "UTMALDG": 2, "HMMA.TF32": 0,
                                                "SYNCS": 0, **none},
        "_ZN5flash10fwd_kernelILi64ELb1EEEv": {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 0,
                                               "SYNCS": 0, **none}}}
    # The instantiation of another form fails its source's design.
    assert kernels.missing_sass(per_kernel) == {
        "flash_fwd.cu": ["_ZN5flash10fwd_kernelILi64ELb1EEEv"]}


def test_missing_sass_holds_each_design_to_its_instructions():
    tf32 = {"HGMMA": 0, "UTMALDG": 0, "HMMA.TF32": 24}
    wgmma = {"HGMMA": 8, "UTMALDG": 4, "HMMA.TF32": 0}
    fwd = "_ZN5flash14fwd_f32_kernelILi64E"
    assert kernels.missing_sass({"flash_fwd_fp32.cu": {fwd: dict(tf32, SYNCS=6)},
                                 "flash_fwd.cu": {"_ZN5flash10fwd_kernelI6__half": wgmma}}) == {}
    # The ring and stream designs need their mbarriers beside their TF32
    # products.
    dkv = "_ZN5flash18bwd_dkv_f32_kernelI"
    ring = dict(tf32, SYNCS=10)
    assert kernels.missing_sass({"flash_bwd_dkv_fp32.cu": {dkv: ring}}) == {}
    no_ring = dict(tf32, SYNCS=0)
    assert kernels.missing_sass({"flash_bwd_dkv_fp32.cu": {dkv: no_ring},
                                 "flash_fwd_fp32.cu": {fwd: no_ring}}) == {
        "flash_bwd_dkv_fp32.cu": [dkv], "flash_fwd_fp32.cu": [fwd]}
    # A wgmma kernel in an fp32 source, or a source without kernels, fails.
    assert kernels.missing_sass({"flash_fwd_fp32.cu": {"_ZN5flash14fwd_f32_kernelI": wgmma},
                                 "flash_fwd.cu": {}}) == {
        "flash_fwd_fp32.cu": ["_ZN5flash14fwd_f32_kernelI"], "flash_fwd.cu": ["no kernel"]}


def test_the_optimizer_kernels_move_128_bits_an_access():
    """The update must show 128-bit loads and stores, the norm's first pass
    128-bit loads; its one-block finishing pass needs neither. A scalar
    build of either stream fails."""
    zero = dict.fromkeys(kernels.SASS_OPS, 0)
    update, sumsq, finish = ("_ZN5adamw19adamw_update_kernelEPKNS_6TensorEiPKfNS_5HyperE",
                             "_ZN5adamw12sumsq_kernelEPKNS_6TensorEiPd",
                             "_ZN5adamw19sumsq_finish_kernelEPKNS_6TensorEixPKdPfS5_")
    vector = dict(zero, **{"LDG.128": 12, "STG.128": 12})
    loads = dict(zero, **{"LDG.128": 4})
    assert kernels.missing_sass({"adamw_fp32.cu": {update: vector, sumsq: loads,
                                                   finish: zero}}) == {}
    assert kernels.missing_sass({"adamw_fp32.cu": {update: loads, sumsq: zero,
                                                   finish: zero}}) == {
        "adamw_fp32.cu": [update, sumsq]}
    counts = kernels._counts("  /*0200*/  LDG.E.128.CONSTANT R8, desc[UR4][R2.64] ;\n"
                             "  /*0210*/  LDG.E.128 R12, desc[UR4][R4.64] ;\n"
                             "  /*0220*/  STG.E.128 desc[UR4][R4.64], R12 ;\n"
                             "  /*0230*/  LDG.E R3, desc[UR4][R6.64] ;\n")
    assert (counts["LDG.128"], counts["STG.128"]) == (2, 1)
    assert not any("fast" in flag for flag in kernels.NVCC_FLAGS)


def test_the_permutation_kernels_move_128_bits_an_access():
    """The expert layer's scatters and gather-sums (with a gate and
    without) must show 128-bit loads and stores; mark_kernel, which writes a
    byte a named row, needs neither. A scalar build fails."""
    zero = dict.fromkeys(kernels.SASS_OPS, 0)
    src = "moe_permute.cu"
    assert kernels.DESIGN[src] == "warp-row-permute"
    assert kernels.DESIGN_SASS["warp-row-permute"] == ("LDG.128", "STG.128")
    scatter = ["_ZN11moe_permute14scatter_kernelEPK13__nv_bfloat16PKxPS0_PKhxiixx",
               "_ZN11moe_permute19scatter_gate_kernelEPK13__nv_bfloat16PKxPKfS2_PS0_PfPKhxiixx"]
    gather = ["_ZN11moe_permute17gather_sum_kernelILb0EEEvPK13__nv_bfloat16PKxPKfPS1_xii",
              "_ZN11moe_permute17gather_sum_kernelILb1EEEvPK13__nv_bfloat16PKxPKfPS1_xii"]
    mark = "_ZN11moe_permute11mark_kernelEPKxxPh"
    vector = dict(zero, **{"LDG.128": 9, "STG.128": 8})
    assert kernels.missing_sass({src: {**dict.fromkeys(scatter + gather, vector),
                                       mark: zero}}) == {}
    loads = dict(zero, **{"LDG.128": 9})
    assert kernels.missing_sass({src: {scatter[0]: vector, scatter[1]: loads,
                                       gather[0]: zero, gather[1]: vector, mark: zero}}) == {
        src: [scatter[1], gather[0]]}
    assert kernels.required_sass(src, mark) == ()
