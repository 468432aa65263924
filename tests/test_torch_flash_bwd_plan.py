"""The flash backward's dk/dv launch plan (`bwd_launch_plan`, `dkv_work`) and
its split query loop, on the CPU: the plan's CTAs cover every query tile of
every (batch row, head, key block) exactly once; `flash_backward_plain` run
slice by slice over the plan's query slices, its fp32 partials summed in
slice order (what `csrc/flash_attn_bwd.cu` computes under a split), matches
the unsplit plain backward and JAX's `_flash_backward` (Pallas in interpret
mode). Tolerances: 1e-5 between the split and unsplit plain versions (fp32
sums in another order, outputs of order 0.01..1), and the JAX parity tests'
2e-5. The CUDA kernel itself is held against the same plain version at every
split by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.ops import flash_attention as jfa
from adaface_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
SMS = 132  # the H100's SMs
SPLIT_ATOL = 1e-5
JAX_ATOL = 2e-5

# (B, H, Lq, Lk, d): the recon micro-step's self-attentions, its
# cross-attention under CROSS=1, the one-head fold, and edge shapes
PLAN_SHAPES = [(3, 8, 4096, 4096, 40), (3, 8, 1024, 1024, 80), (3, 8, 256, 256, 160),
               (3, 8, 4096, 128, 40), (3, 8, 1024, 128, 80), (24, 1, 4096, 4096, 40),
               (1, 2, 1, 64, 40), (2, 3, 333, 200, 160), (1, 2, 1000, 77, 80),
               (2, 8, 130, 130, 80), (3, 1, 300, 4100, 40)]


def _check_cover(b, h, lq, lk, d, split):
    nqt = -(-lq // tfa.BWD_TILE)
    rows = tfa.bwd_cta_rows(d)
    work = tfa.dkv_work(b, h, lq, lk, d, split)
    assert len(work) == -(-lk // rows) * h * b * split
    seen = {}
    for bi, hi, k0, t0, t1 in work:
        assert t0 < t1, "every slice has a query tile"
        seen.setdefault((bi, hi, k0), []).extend(range(t0, t1))
    assert sorted(seen) == sorted((bi, hi, k0) for bi in range(b) for hi in range(h)
                                  for k0 in range(0, lk, rows))
    for tiles in seen.values():
        assert sorted(tiles) == list(range(nqt))  # each query tile exactly once


@pytest.mark.parametrize("b,h,lq,lk,d", PLAN_SHAPES)
def test_plan_covers_every_query_tile_once(b, h, lq, lk, d):
    plan = tfa.bwd_launch_plan(b, h, lq, lk, d, SMS)
    assert 1 <= plan.split <= min(tfa.BWD_MAX_SPLIT, -(-lq // tfa.BWD_TILE))
    assert plan.key_ctas == -(-lk // tfa.bwd_cta_rows(d)) * h * b
    _check_cover(b, h, lq, lk, d, plan.split)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_every_split_covers_every_query_tile_once(d):
    for split in range(1, tfa.BWD_MAX_SPLIT + 1):
        _check_cover(1, 2, 520, 190, d, split)


def test_plan_splits_only_grids_that_leave_sms_idle():
    # 768 / 192 / 768 key CTAs fill the card: no split
    for shape in [(3, 8, 4096, 4096, 40), (3, 8, 1024, 1024, 80), (24, 1, 4096, 4096, 40)]:
        assert tfa.bwd_launch_plan(*shape, SMS).split == 1
    # the cross-attention's 128 keys: 24 key CTAs, split to fill 132 SMs
    for shape in [(3, 8, 4096, 128, 40), (3, 8, 1024, 128, 80)]:
        plan = tfa.bwd_launch_plan(*shape, SMS)
        assert plan.key_ctas == 24 and plan.split > 1
        assert plan.key_ctas * plan.split <= SMS


def _case(rng, b, lq, lk, heads, d, masked, dtype=np.float32):
    q, do = (rng.standard_normal((b, lq, heads * d)).astype(dtype) for _ in range(2))
    k, v = (rng.standard_normal((b, lk, heads * d)).astype(dtype) for _ in range(2))
    bias = None
    if masked:
        bias = np.where(rng.random((b, lk)) > 0.3, 0.0, -1e30).astype(np.float32)
        bias[0] = -1e30  # a fully masked batch row
    return q, k, v, do, bias


def _split_backward(tq, tk, tv, tb, o, tdo, lse, heads, split):
    """dk, dv, dbias_h as the split kernel sums them: slice partials in order."""
    parts = tfa.dkv_slices_plain(tq, tk, tv, tb, o, tdo, lse, heads, split=split)
    assert len(parts) == split
    total = [p.clone() for p in parts[0]]
    for part in parts[1:]:
        for acc, p in zip(total, part):
            acc += p
    return total


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("split", [2, 3, 5])
def test_split_plain_backward_matches_unsplit(rng, split, masked):
    b, lq, lk, heads, d = 2, 300, 100, 2, 8  # 5 query tiles, the last ragged
    q, k, v, do, bias = _case(rng, b, lq, lk, heads, d, masked)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    o = tfa.flash_attention_blc_plain(tq, tk, tv, heads, tb)
    lse = tfa.row_lse_plain(tq, tk, heads, tb)
    _, dk, dv, db = tfa.flash_backward_plain(tq, tk, tv, tb, o, tdo, lse, heads)
    sk, sv, sb = _split_backward(tq, tk, tv, tb, o, tdo, lse, heads, split)
    for name, got, ref in (("dk", sk, dk), ("dv", sv, dv), ("dbias", sb, db)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=SPLIT_ATOL, err_msg=name)
    if masked:  # the fully masked row's dbias is not zeroed, as in the TPU kernel
        assert np.abs(sb[0].numpy()).max() > 1e-4


def _bhld(x, heads):
    b, l, w = x.shape
    return jnp.asarray(x).reshape(b, l, heads, w // heads).transpose(0, 2, 1, 3)


def _blc(x):
    x = np.asarray(x)
    b, h, l, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, l, h * d)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("split", [3, 4])
def test_split_plain_backward_matches_jax_flash_backward(rng, split, masked):
    b, l, heads, d = 2, 256, 2, 8  # 4 query tiles
    q, k, v, do, bias = _case(rng, b, l, l, heads, d, masked)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    o = tfa.flash_attention_blc_plain(tq, tk, tv, heads, tb)
    lse = tfa.row_lse_plain(tq, tk, heads, tb)
    got = _split_backward(tq, tk, tv, tb, o, tdo, lse, heads, split)
    ref = jfa._flash_backward(_bhld(q, heads), _bhld(k, heads), _bhld(v, heads),
                              None if bias is None else jnp.asarray(bias),
                              _bhld(o.numpy(), heads), _bhld(do, heads), d ** -0.5)
    for name, g, r in zip(("dk", "dv"), got[:2], ref[1:3]):
        np.testing.assert_allclose(g.numpy(), _blc(r), atol=JAX_ATOL, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[3]), atol=JAX_ATOL,
                               err_msg="dbias per head")
