"""The fp32 flash backward's launch plan (`bwd_fp32_launch_plan`,
`bwd_fp32_smem`, `tile_slices`), on the CPU: at every shape phase 4g of
`chip_smoke.py` runs the backward (the B3 / B4 training shapes, its edge
cases), at edge lengths and at the K6 one-head fold, dq's CTAs cover every
query row and dk/dv's every key of every (batch row, head) exactly once,
and a split's slices every streamed tile once; every CTA takes at most the
227 KB of shared memory an H100 gives a CTA and is a plan the C entries of
`csrc/flash_attn_fp32.cu` are built for; the L256 d160 grids put a CTA on
each of the 132 SMs; the plan's tiling constants are the source's; the
slices' partials, summed in slice order, are `flash_backward_plain`'s
function in fp32. The kernels themselves are held against
`flash_backward_plain` at these shapes by `chip_smoke.py` phase 4g and,
emulated on the CPU, by `test_torch_flash_fp32_emulated.py`."""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from adaface_tpu_torch.ops import flash_attention as tfa

SMS = 132  # the H100's SMs
MAX_SMEM = 227 * 1024  # shared memory a CTA may take on an H100
CSRC = os.path.join(os.path.dirname(__file__), "..", "adaface_tpu_torch", "csrc")

# (B, H, Lq, Lk, d)
_4G = ([(b, h, l, l, d) for b, l, h, d in chip_smoke.FP32_TRAIN_SHAPES]
       + [(b, h, lq, lk, d) for b, lq, lk, h, d, *_ in chip_smoke.FP32_BWD_EDGES])
_EDGE = [(2, 3, lq, lk, d) for lq, lk in ((200, 300), (300, 333), (333, 4095), (4095, 200))
         for d in (40, 80, 160)]
_FOLDS = [(b * h, 1, l, l, d) for b, l, h, d in chip_smoke.FP32_TRAIN_SHAPES]
PLAN_SHAPES = sorted(set(_4G + _EDGE + _FOLDS))


def _launches(b, h, lq, lk, d):
    plan = tfa.bwd_fp32_launch_plan(b, h, lq, lk, d, SMS)
    return (("dq", plan.dq, lq), ("dkv", plan.dkv, lk))


@pytest.mark.parametrize("b,h,lq,lk,d", PLAN_SHAPES)
def test_plan_covers_every_row_and_key_once(b, h, lq, lk, d):
    for kind, launch, n in _launches(b, h, lq, lk, d):
        # the grid is (blocks x slices, heads, batch rows)
        blocks = tfa.fwd_fp32_blocks(b, h, n, launch.rows)
        assert len(blocks) * launch.split == launch.ctas, kind
        seen = {}
        for bi, hi, r0, r1 in blocks:
            assert 0 <= r0 < r1 <= n and r1 - r0 <= launch.rows
            seen.setdefault((bi, hi), []).extend(range(r0, r1))
        assert sorted(seen) == [(bi, hi) for bi in range(b) for hi in range(h)]
        for covered in seen.values():
            assert covered == list(range(n)), kind  # each row once, in order


@pytest.mark.parametrize("b,h,lq,lk,d", PLAN_SHAPES)
def test_plan_is_one_the_kernels_are_built_for(b, h, lq, lk, d):
    """1, 2 or 4 warps a CTA of BWD_FP32_WARP_ROWS[kind][d] resident rows
    each, within the shared memory a CTA may take; a split of 1 to
    BWD_FP32_MAX_SPLIT and at most the streamed tiles."""
    for kind, launch, _ in _launches(b, h, lq, lk, d):
        warps = launch.threads // 32
        assert launch.threads == 32 * warps and warps in tfa.BWD_FP32_WARPS
        assert launch.rows == warps * tfa.BWD_FP32_WARP_ROWS[kind][d]
        assert launch.smem == tfa.bwd_fp32_smem(kind, d, warps) <= MAX_SMEM
        streamed = lk if kind == "dq" else lq
        assert 1 <= launch.split <= min(tfa.BWD_FP32_MAX_SPLIT, -(-streamed // 64))


@pytest.mark.parametrize("n", [20, 64, 65, 200, 300, 333, 1024, 4095])
@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_slices_cover_every_streamed_tile_once(n, split):
    tiles = -(-n // 64)
    if split > tiles:
        return
    slices = tfa.tile_slices(n, split)
    assert len(slices) == split
    covered = [r for r0, r1 in slices for r in range(r0, r1)]
    assert covered == list(range(n))  # each row once, in order
    assert all(r0 % 64 == 0 and r1 > r0 for r0, r1 in slices)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_every_plan_fits_in_shared_memory(kind, d):
    for warps in tfa.BWD_FP32_WARPS:
        assert tfa.bwd_fp32_smem(kind, d, warps) <= MAX_SMEM


@pytest.mark.parametrize("b", [3, 4])
def test_l256_d160_puts_a_cta_on_every_sm(b):
    for kind, launch, _ in _launches(b, 8, 256, 256, 160):
        assert launch.ctas >= SMS, kind


@pytest.mark.parametrize("b", [3, 4, 24])
def test_l4096_d40_takes_128_rows_a_cta(b):
    """The L4096 d40 grids fill the card many times over: 4 warps of 32
    rows or keys, the streamed side read once per 128."""
    h = 1 if b == 24 else 8
    for kind, launch, _ in _launches(b, h, 4096, 4096, 40):
        assert (launch.rows, launch.threads) == (128, 128), kind


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_forced_warps(warps):
    """`chip_smoke.forced_fp32_bwd`, which builds the forced plans of
    `flash_variants.py` and 4g's forced splits: the plan's launch with its
    warps (or split) replaced, a plan the C entries take."""
    plan = tfa.bwd_fp32_launch_plan(3, 8, 1024, 1024, 80, SMS)
    for kind, launch in (("dq", plan.dq), ("dkv", plan.dkv)):
        rows, threads, split = chip_smoke.forced_fp32_bwd(tfa, kind, 80, launch, warps=warps)
        assert (threads, split) == (32 * warps, launch.split)
        assert rows == warps * tfa.BWD_FP32_WARP_ROWS[kind][80]
        assert chip_smoke.forced_fp32_bwd(tfa, kind, 80, launch, split=3) == launch[:2] + (3,)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_unbuilt_head_dim_is_refused(d):
    with pytest.raises(ValueError, match="head dims"):
        tfa.bwd_fp32_launch_plan(3, 8, 256, 256, d, SMS)


def test_tiling_matches_the_source():
    """The Python mirror of BwdCfg (rows a warp, ring depth, stage width and
    layout, p tile) against csrc/flash_attn_fp32.cu."""
    src = open(os.path.join(CSRC, "flash_attn_fp32.cu")).read()
    assert f"constexpr int BWD_STAGES = {tfa.BWD_FP32_STAGES};" in src
    assert f"constexpr int BWD_MAX_WARPS = {max(tfa.BWD_FP32_WARPS)};" in src
    assert "constexpr int LDP = BK + 8;" in src and tfa._FWD_FP32_LDP == 64 + 8
    cfg = src[src.index("struct BwdCfg {"):]
    cfg = cfg[:cfg.index("};")]
    assert "static constexpr int CW = 40;" in cfg
    assert "static constexpr int LDC = CW + 4;" in cfg
    assert "static constexpr int STAGE = BK * LDC + BK;" in cfg
    assert "static constexpr int WR = 4 * TR;" in cfg
    assert "static constexpr int LDR = D + 4;" in cfg
    tr = re.search(r"static constexpr int TR = DKV \? \(D == 40 \? (\d+) : D == 80 \? (\d+) : "
                   r"(\d+)\) : \(D > 40 \? (\d+) : (\d+)\);", cfg)
    assert tr, "BwdCfg::TR not found"
    dkv40, dkv80, dkv160, dq_wide, dq40 = (int(g) for g in tr.groups())
    for d, dkv in ((40, dkv40), (80, dkv80), (160, dkv160)):
        assert tfa.BWD_FP32_WARP_ROWS["dkv"][d] == 4 * dkv
        assert tfa.BWD_FP32_WARP_ROWS["dq"][d] == 4 * (dq_wide if d > 40 else dq40)
    # the smem model: two resident tiles, the ring, the p tiles, dq's lse
    # and delta (floats)
    for kind in ("dq", "dkv"):
        for d in (40, 80, 160):
            wr = tfa.BWD_FP32_WARP_ROWS[kind][d]
            want = (2 * wr * (d + 4) + tfa.BWD_FP32_STAGES * (64 * 44 + 64) + wr * 72
                    + (2 * wr if kind == "dq" else 0))
            assert tfa.bwd_fp32_smem(kind, d, 1) == 4 * want



@pytest.mark.parametrize("split", [2, 3])
@pytest.mark.parametrize("d,with_bias", [(40, True), (80, False), (160, True)])
def test_split_partials_sum_to_the_plain_backward(split, d, with_bias):
    """dq over key slices and dk, dv, dbias over query slices (the split
    kernels' partials: each slice's plain backward, scaled per slice), summed
    in slice order, against the unsplit plain backward in fp32."""
    rng = np.random.default_rng(split * 100 + d)
    b, h, lq, lk = 2, 2, 200, 300
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32))
                   for n in (lq, lk, lk, lq))
    bias = (torch.from_numpy(np.where(rng.random((b, lk)) > 0.3, 0.0, -1e30)
                             .astype(np.float32)) if with_bias else None)
    o = tfa.flash_attention_blc_plain(q, k, v, h, bias)
    lse = tfa.row_lse_plain(q, k, h, bias)
    want = tfa.flash_backward_plain(q, k, v, bias, o, do, lse, h)
    dq = sum(tfa.flash_backward_plain(q, k[:, r0:r1], v[:, r0:r1],
                                      None if bias is None else bias[:, r0:r1], o, do, lse,
                                      h)[0]
             for r0, r1 in tfa.tile_slices(lk, split))
    parts = tfa.dkv_slices_plain(q, k, v, bias, o, do, lse, h, split=split)
    got = [dq] + [sum(p[i] for p in parts) for i in range(3)]
    for what, g, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        if what == "dbias" and bias is None:
            continue
        diff = (g.double() - ref.double())
        assert (diff.norm() / ref.double().norm()).item() <= chip_smoke.FP32_REL_TOL, what
        assert (diff.abs().max() / ref.abs().max()).item() <= chip_smoke.FP32_ABS_TOL, what
