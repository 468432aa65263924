"""The fp32 flash forward's launch plan (`fwd_fp32_launch_plan`,
`fwd_fp32_blocks`, `fwd_fp32_smem`), on the CPU: at every shape phase 4g
of `chip_smoke.py` runs (the B3 / B4 training shapes, the generate shapes
of MAIN_SHAPES, the forward's edge cases), the K6/K7 one-head folds and
ragged lengths, the plan's CTAs cover every query row of every (batch row,
head) exactly once, take at most the 227 KB of shared memory an H100 gives a
CTA, and are a plan the C entry of `csrc/flash_attn_fp32.cu` is built for;
the B3 and B4 L256 d160 grids put a CTA on each of the 132 SMs; a head dim
the kernel is not built for is refused. The kernel itself is held against
the plain forward at these shapes by `chip_smoke.py` phase 4g."""

import os
import re

import pytest

import chip_smoke
from adaface_tpu_torch.ops import flash_attention as tfa

SMS = 132  # the H100's SMs
MAX_SMEM = 227 * 1024  # shared memory a CTA may take on an H100
CSRC = os.path.join(os.path.dirname(__file__), "..", "adaface_tpu_torch", "csrc")

# (B, H, Lq, Lk, d)
_4G = ([(b, h, l, l, d) for b, l, h, d in chip_smoke.FP32_TRAIN_SHAPES]
       + [(b, h, l, l, d) for b, l, h, d in chip_smoke.FP32_GENERATE_SHAPES]
       + [(b, h, lq, lk, d) for b, lq, lk, h, d, *_ in chip_smoke.FP32_FWD_EDGES])
_FOLDS = [(b * h, 1, l, l, d) for b, l, h, d in
          list(chip_smoke.TRAIN_SHAPES) + list(chip_smoke.FP32_GENERATE_SHAPES)]
_RAGGED = [(2, 3, 200, 77, 40), (2, 3, 200, 77, 80), (2, 3, 200, 77, 160),
           (1, 2, 4095, 4095, 40), (1, 2, 4095, 4095, 80), (1, 2, 4095, 4095, 160),
           (1, 1, 1, 64, 80), (3, 8, 4096, 128, 40), (3, 8, 1024, 128, 80)]
PLAN_SHAPES = sorted(set(_4G + _FOLDS + _RAGGED))


@pytest.mark.parametrize("b,h,lq,lk,d", PLAN_SHAPES)
def test_plan_covers_every_query_row_once(b, h, lq, lk, d):
    plan = tfa.fwd_fp32_launch_plan(b, h, lq, lk, d, SMS)
    blocks = tfa.fwd_fp32_blocks(b, h, lq, plan.rows)
    assert len(blocks) == plan.ctas
    seen = {}
    for bi, hi, r0, r1 in blocks:
        assert 0 <= r0 < r1 <= lq and r1 - r0 <= plan.rows
        seen.setdefault((bi, hi), []).extend(range(r0, r1))
    assert sorted(seen) == [(bi, hi) for bi in range(b) for hi in range(h)]
    for covered in seen.values():
        assert covered == list(range(lq))  # each row once, in order


@pytest.mark.parametrize("b,h,lq,lk,d", PLAN_SHAPES)
def test_plan_is_one_the_kernel_is_built_for(b, h, lq, lk, d):
    """1, 2 or 4 warps a CTA, each row group of FWD_FP32_WARP_ROWS[d] rows
    taken by one warp or two (the key split), within the shared memory a
    CTA may take (Q tile, ring, the warps' p tiles)."""
    plan = tfa.fwd_fp32_launch_plan(b, h, lq, lk, d, SMS)
    warps = plan.threads // 32
    assert plan.threads == 32 * warps and warps in tfa.FWD_FP32_WARPS
    assert plan.key_split in (1, 2)
    assert plan.rows * plan.key_split == warps * tfa.FWD_FP32_WARP_ROWS[d]
    assert plan.smem == tfa.fwd_fp32_smem(d, plan.rows, warps, plan.key_split)
    assert plan.smem <= MAX_SMEM


@pytest.mark.parametrize("d", sorted(tfa.FWD_FP32_WARP_ROWS))
def test_every_plan_fits_in_shared_memory(d):
    for warps in tfa.FWD_FP32_WARPS:
        for ks in (1, 2):
            if warps % ks == 0:
                rows = warps // ks * tfa.FWD_FP32_WARP_ROWS[d]
                assert tfa.fwd_fp32_smem(d, rows, warps, ks) <= MAX_SMEM


@pytest.mark.parametrize("b", [3, 4])
def test_l256_d160_puts_a_cta_on_every_sm(b):
    plan = tfa.fwd_fp32_launch_plan(b, 8, 256, 256, 160, SMS)
    assert plan.ctas >= SMS
    assert plan.key_split == 2  # few row groups an SM: the keys are split


def test_large_grids_take_128_rows_a_cta():
    """The L4096 d40 grids fill the card many times over: 4 warps of 32
    rows, K and V read once per 128 query rows."""
    for b in (3, 4, 8, 16):
        plan = tfa.fwd_fp32_launch_plan(b, 8, 4096, 4096, 40, SMS)
        assert (plan.rows, plan.threads, plan.key_split) == (128, 128, 1)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_unbuilt_head_dim_is_refused(d):
    with pytest.raises(ValueError, match="head dims"):
        tfa.fwd_fp32_launch_plan(3, 8, 256, 256, d, SMS)


def test_tiling_matches_the_source():
    """The Python mirror of FwdCfg (warp rows, ring depth, stage width, p
    tile) against csrc/flash_attn_fp32.cu."""
    src = open(os.path.join(CSRC, "flash_attn_fp32.cu")).read()
    assert f"constexpr int STAGES = {tfa.FWD_FP32_STAGES};" in src
    assert "constexpr int LDP = BK + 8;" in src and tfa._FWD_FP32_LDP == 64 + 8
    tm = re.search(r"static constexpr int TM = D > 80 \? (\d+) : (\d+);", src)
    assert tm, "FwdCfg::TM not found"
    assert "static constexpr int WR = 4 * TM;" in src
    for d, wr in tfa.FWD_FP32_WARP_ROWS.items():
        assert wr == 4 * int(tm.group(1) if d > 80 else tm.group(2))
    assert "static constexpr int CW = D == 160 && KS == 2 ? 80 : 40;" in src
    assert tfa.fwd_fp32_smem(160, 32, 4, 2) - tfa.fwd_fp32_smem(160, 32, 4, 1) == \
        4 * tfa.FWD_FP32_STAGES * 64 * 40
