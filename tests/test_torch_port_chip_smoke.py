"""The card check's gates that read compiler output (``chip_smoke.py``):
``wg_ptxas_faults`` over ``nvcc -Xptxas -v`` logs, which fails the build
of the bf16 conv kernels on a spill or a serialised wgmma and lets the
float32 kernels spill, and ``kernel_sections``, which splits a
``cuobjdump`` text into each kernel's lines for the SASS gate.  Both run
only on the card's build; here they read short texts in that format."""

import pytest

WG = "_ZN3mrf12_GLOBAL__N_118mrf_conv_wg_kernelILi128ELb0EEEvNS0_6WgConvE14CUtensorMap_st"
F32 = "_ZN3mrf12_GLOBAL__N_119mrf_conv_f32_kernelILi64EEEvNS0_8ConvArgsE"


def ptxas_log(fn: str, spill_stores: int = 0, spill_loads: int = 0,
              extra: str = "") -> str:
    """One function's lines of an ``nvcc -Xptxas -v`` log."""
    return (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {fn}\n"
            f"    0 bytes stack frame, {spill_stores} bytes spill stores, "
            f"{spill_loads} bytes spill loads\n"
            f"{extra}"
            "ptxas info    : Used 168 registers, 536 bytes cmem[0]\n")


SERIALIZED = ("ptxas info    : (C7515) Potential Performance Loss: "
              "wgmma.mma_async instructions are serialized due to "
              f"insufficient register resources for the wgmma pipeline in "
              f"the function '{WG}'\n")


@pytest.mark.parametrize("log, faulty", [
    (ptxas_log(WG) + ptxas_log(F32), False),
    (ptxas_log(WG, spill_stores=8, spill_loads=8) + ptxas_log(F32), True),
    (ptxas_log(WG, extra=SERIALIZED) + ptxas_log(F32), True),
    (ptxas_log(WG) + ptxas_log(F32, spill_stores=16, spill_loads=24), False),
], ids=["clean", "wg_spill", "wgmma_serialized", "f32_spill"])
def test_wg_ptxas_faults(log, faulty):
    """A clean log passes; a spill in an ``mrf_conv_wg`` kernel and a
    serialised wgmma are faults; a spill in a float32 kernel is not."""
    import chip_smoke

    faults = chip_smoke.wg_ptxas_faults(log)
    assert bool(faults) == faulty, faults
    if faulty:
        assert len(faults) == 1 and WG in faults[0]


def test_kernel_sections_splits_sass_by_function():
    """Each ``Function :`` header of ``cuobjdump -sass`` opens its
    kernel's section; the lines before the first header belong to none."""
    import chip_smoke

    sass = (
        "\n\tcode for sm_90a\n"
        f"\t\tFunction : {WG}\n"
        "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
        "        /*0000*/  LDC R1, c[0x0][0x28] ;\n"
        "        /*0a40*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
        "\t\t..........\n"
        f"\t\tFunction : {F32}\n"
        "        /*0000*/  FFMA R2, R3, R4, R2 ;\n")
    sections = chip_smoke.kernel_sections(sass)
    assert list(sections) == [WG, F32]
    assert sum("HGMMA" in ln for ln in sections[WG]) == 1
    assert len(sections[WG]) == 4
    assert [ln.split()[1] for ln in sections[F32]] == ["FFMA"]
