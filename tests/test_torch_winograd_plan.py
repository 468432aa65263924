"""The Winograd kernel's launch plan and split (`adaface_tpu_torch.ops.
winograd.launch_plan`, `plan_items`, `winograd_conv3x3_split_plain`) and
the K-major weight layout its product launch reads.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against the
plain versions there); here the plan's work items are checked to cover every
(row block, column block, position, K chunk) once, and the plain version of
a split launch (fp32 partials of the step slices, summed in slice order) is
held against the unsplit plain version and against JAX's `winograd_conv3x3`
(its Pallas kernel in interpret mode). Tolerance: fp32 1e-5 of the output's
scale, as in `test_torch_winograd.py` (sums in other orders)."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.ops import winograd as jw
from adaface_tpu_torch.ops import winograd as tw

torch.set_num_threads(2)

SMS = 132  # H100 SXM
# (B, H, W, Cin, Cout) of the 15 3x3 stride-1 conv shapes of a generate UNet
# call at 512x512 that the gates admit under ADAFACE_WINOGRAD=1 (chip_smoke
# phase 4d records them with hooks)
UNET_SHAPES = [(8, 64, 64, 4, 320), (8, 64, 64, 320, 320), (16, 8, 8, 1280, 1280),
               (16, 16, 16, 640, 1280), (16, 16, 16, 1280, 1280), (16, 32, 32, 320, 640),
               (16, 32, 32, 640, 640), (16, 32, 32, 960, 640), (16, 32, 32, 1280, 640),
               (16, 32, 32, 1920, 640), (16, 64, 64, 320, 4), (16, 64, 64, 320, 320),
               (16, 64, 64, 640, 320), (16, 64, 64, 640, 640), (16, 64, 64, 960, 320)]
# (M, Cin, Cout): ragged row blocks, channels that are no tile multiple
RAGGED = [(1, 4, 4), (100, 130, 70), (129, 64, 64), (300, 320, 200), (1000, 48, 1280)]


def _mcc(shape):
    b, h, w, cin, cout = shape
    return b * h * w // 4, cin, cout


def _covered_once(m, cin, cout, plan):
    nk = -(-cin // tw.K_TILE)
    mblk, nblk = -(-m // tw.M_TILE), -(-cout // tw.N_TILE)
    items = tw.plan_items(m, cin, cout, plan)
    assert len(items) == plan.grid == mblk * nblk * plan.split
    seen = {}
    for it in items:
        assert it.row0 % tw.M_TILE == 0 and it.row0 < m
        assert it.col0 % tw.N_TILE == 0 and it.col0 < cout
        assert 0 <= it.k0 < it.k1 <= 16 * nk and 0 <= it.slice < plan.split
        for st in range(it.k0, it.k1):
            key = (it.row0, it.col0, st // nk, st % nk)
            seen[key] = seen.get(key, 0) + 1
    want = set(itertools.product(range(0, mblk * tw.M_TILE, tw.M_TILE),
                                 range(0, nblk * tw.N_TILE, tw.N_TILE), range(16), range(nk)))
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("shape", UNET_SHAPES)
def test_plan_covers_every_step_once_unet(shape):
    m, cin, cout = _mcc(shape)
    _covered_once(m, cin, cout, tw.launch_plan(m, cin, cout, SMS))


@pytest.mark.parametrize("mcc", RAGGED)
def test_plan_covers_every_step_once_ragged(mcc):
    m, cin, cout = mcc
    plan = tw.launch_plan(m, cin, cout, SMS)
    steps = 16 * -(-cin // tw.K_TILE)
    for split in sorted({1, 2, 3, plan.split, steps}):
        for m_fastest in (False, True):
            _covered_once(m, cin, cout, plan._replace(
                split=split, m_fastest=m_fastest,
                grid=-(-m // tw.M_TILE) * -(-cout // tw.N_TILE) * split))


def test_plan_splits_only_where_sms_idle():
    """A split only where the unsplit grid's last wave leaves SMs idle; the
    small-M C1280 shapes split; a grid of whole waves never does."""
    for shape in UNET_SHAPES:
        m, cin, cout = _mcc(shape)
        plan = tw.launch_plan(m, cin, cout, SMS)
        tiles = -(-m // tw.M_TILE) * -(-cout // tw.N_TILE)
        assert plan.grid == tiles * plan.split
        if plan.split > 1:
            assert tiles % SMS, shape
    for shape in [(16, 8, 8, 1280, 1280), (16, 16, 16, 1280, 1280)]:
        assert tw.launch_plan(*_mcc(shape), SMS).split > 1, shape
    for waves in (1, 2, 5):
        assert tw.launch_plan(waves * SMS * tw.M_TILE, 1280, 64, SMS).split == 1
        assert tw.launch_plan(tw.M_TILE, 1280, waves * SMS * tw.N_TILE, SMS).split == 1


def test_plan_rasterises_the_reread_operand():
    """Column blocks fastest (CTAs share V's rows) where U is the smaller
    operand; row blocks fastest (CTAs share U's columns) where V is."""
    assert not tw.launch_plan(16384, 320, 320, SMS).m_fastest
    assert tw.launch_plan(256, 1280, 1280, SMS).m_fastest


SPLIT_CASES = [((2, 8, 8, 128, 128), 3), ((1, 16, 8, 192, 64), 7), ((1, 6, 10, 4, 32), 16),
               ((2, 8, 6, 130, 70), 48)]


@pytest.mark.parametrize("shape,split", SPLIT_CASES)
def test_split_plain_matches_plain_and_jax(rng, shape, split):
    b, h, w, cin, cout = shape
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    ref = np.asarray(jw.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    u = tw.transform_weights(torch.from_numpy(k))
    parts = tw.split_partials(tx, u, split)
    assert parts.shape == (split, 2, 2, b * h * w // 4, cout)
    got = tw.winograd_conv3x3_split_plain(tx, parts, tb).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)
    np.testing.assert_allclose(got, tw.winograd_conv3x3_plain(tx, u, tb).numpy(),
                               atol=1e-5 * scale)
    # a slice's partial dropped from the sum (chip_smoke's planted fault) is
    # far outside that tolerance
    wrong = tw.winograd_conv3x3_split_plain(tx, parts[1:], tb).numpy()
    assert np.abs(wrong - ref).max() > 1e-2 * scale


@pytest.mark.parametrize("cin,cout", [(4, 36), (64, 64), (130, 70), (320, 320)])
def test_padded_weights_k_major(rng, cin, cout):
    """The product launch's weights: U_ij transposed to [Cout_p, Cin_p]
    (K-major), Cin padded to a multiple of 64 (a 128-byte swizzled box row),
    Cout to 64, zeros in the padding, transform_weights' values exactly."""
    k = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    u = tw.transform_weights(k.bfloat16())
    ut = tw.padded_weights(u)
    cin_p, cout_p = -(-cin // 64) * 64, -(-cout // 64) * 64
    assert ut.shape == (16, cout_p, cin_p) and ut.dtype == u.dtype and ut.is_contiguous()
    assert torch.equal(ut[:, :cout, :cin], u.transpose(1, 2))
    assert ut[:, cout:].abs().sum() == 0 and ut[:, :, cin:].abs().sum() == 0
