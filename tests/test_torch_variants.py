"""The text patches of the kernel-variant scripts (`kernel_variants.py`,
`gn_variants.py`, `ff_variants.py` and its `--fp32` variants,
`wino_variants.py`, `flash_variants.py`) and of `chip_smoke.py`'s planted
faults: the tanh-SiLU of K8, and one fault for each fp32 kernel (`FP32_FAULTS`: the online softmax's rescale by alpha
skipped in the fp32 flash forward, a cluster peer's partial left out of
K8's combine, an F chunk skipped in K9's GEMM2, a Winograd position left
out of K10's sum).

nvcc runs only on the card's machine; here each variant's sources are
patched as `kernel_variants.build` patches them before it starts nvcc, so a
kernel edit that leaves a patch behind fails here and not in a chip call.
Variants built from an older tree (`old`) need `_checkout/` and are left
out."""

import pytest

import chip_smoke
import ff_variants
import flash_variants
import gn_variants
import kernel_variants as kv
import wino_variants


def _specs():
    fwd, bwd = flash_variants.FWD_VARIANTS, flash_variants.BWD_VARIANTS
    fp32, fp32_bwd = flash_variants.FP32_VARIANTS, flash_variants.FP32_BWD_VARIANTS
    sets = [("gn", gn_variants.variant_specs([n for n in gn_variants.VARIANTS if n != "old"])),
            ("ff", ff_variants.variant_specs(list(ff_variants.VARIANTS))),
            ("ff_fp32", ff_variants.fp32_variant_specs(
                [n for n, v in ff_variants.FP32_VARIANTS.items() if v is not None])),
            ("wino", wino_variants.variant_specs([n for n in wino_variants.VARIANTS
                                                  if n != "old"])),
            ("flash", flash_variants.variant_specs(list(fwd), "flash_attn_packed.cu", fwd)),
            ("flash_bwd", flash_variants.variant_specs(
                [n for n in bwd if bwd[n] is not None], "flash_attn_bwd.cu", bwd)),
            ("flash_fp32", flash_variants.variant_specs(
                [n for n in fp32 if fp32[n] is not None], "flash_attn_fp32.cu", fp32)),
            ("flash_fp32_bwd", flash_variants.variant_specs(
                [n for n in fp32_bwd if fp32_bwd[n] is not None], "flash_attn_fp32.cu",
                fp32_bwd))]
    return [(f"{tool}:{name}", spec) for tool, specs in sets for name, spec in specs.items()]


SPECS = _specs()


@pytest.mark.parametrize("spec", [s for _, s in SPECS], ids=[i for i, _ in SPECS])
def test_variant_patches_apply(spec):
    src_dir, source, patches = spec
    files = kv.patched_sources(src_dir, source, patches)
    assert src_dir == kv.CSRC and "kernel.cu" in files
    for _, new in patches:
        assert any(new in text for text in files.values())


def test_tanh_fault_replaces_the_kernels_silu():
    """The fault's patch finds the kernel's one SiLU line and swaps it."""
    src = open(f"{kv.CSRC}/gn_silu.cu").read()
    assert src.count(chip_smoke.GN_SILU_LINE) == 1
    text = kv.patched_sources(kv.CSRC, "gn_silu.cu", chip_smoke.GN_TANH_PATCHES)["kernel.cu"]
    assert chip_smoke.GN_SILU_LINE not in text and "tanh.approx.f32" in text


def test_patch_goes_to_the_source_before_a_header():
    """`tma_load_2d(` is in the source and in the header that defines it:
    the source's calls are patched, the definition is kept."""
    patches = dict(wino_variants.VARIANTS["noload"][0])
    files = kv.patched_sources(kv.CSRC, "winograd.cu", list(patches.items()))
    assert "if (0) tma_load_2d(" in files["kernel.cu"]
    assert "if (0)" not in files["hopper_common.cuh"]


def test_patch_that_does_not_apply_raises():
    with pytest.raises(ValueError, match="does not apply"):
        kv.patched_sources(kv.CSRC, "gn_silu.cu", [("no such text", "x")])
    with pytest.raises(ValueError, match="no "):
        kv.patched_sources(kv.OLD_CSRC + "_missing", "gn_silu.cu", [])


@pytest.mark.parametrize("key", sorted(chip_smoke.FP32_FAULTS))
def test_fp32_fault_patches_change_one_place(key):
    """Each fp32 kernel's planted fault replaces exactly one line of its
    source, and its C entry is declared there, so 4g and 4h launch the
    patched kernel through the wrapper."""
    source, entry, _, patches = chip_smoke.FP32_FAULTS[key]
    src = open(f"{kv.CSRC}/{source}").read()
    assert f'extern "C" int {entry}(' in src
    text = kv.patched_sources(kv.CSRC, source, patches)["kernel.cu"]
    assert text != src
    for old, new in patches:
        assert src.count(old) == 1 and new in text and new not in src
