"""The GroupNorm+SiLU kernel's launch plan and summation tree
(`adaface_tpu_torch.ops.fused_norm.launch_plan`, `cta_rows`,
`cluster_partials`, `group_norm_silu_from_partials`).

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against the
plain version there). Here the plan is checked at every shape the fused
paths give K8 and at the edge shapes `chip_smoke.py` adds: every row of an
image belongs to exactly one CTA of its cluster, the cluster is a power of
two of at most 16 CTAs (and at most N), and the threads are whole row
lanes within the kernel's limits (one row lane past C 4096). The kernel's
summation tree in plain ops (per-CTA partials, then added in rank order)
is held against `group_norm_silu_plain` and against JAX's `_gn_silu_kernel`
(Pallas in interpret mode). Tolerance: fp32, 2e-5 absolute on outputs of
order 1, as in `test_torch_fused_norm.py` (sums in other orders)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adaface_tpu.ops.fused_norm as jfn
import chip_smoke
from adaface_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(2)

SMS = 132  # H100 SXM
ATOL = 2e-5
SHAPES = sorted(set(chip_smoke.GN_SHAPES) | set(chip_smoke.GN_TRAIN_SHAPES))
EDGE = chip_smoke.GN_EDGE_SHAPES
CU = Path(tfn.__file__).resolve().parent.parent / "csrc" / "gn_silu.cu"


def _check_plan(b, n, c):
    plan = tfn.launch_plan(b, n, c, SMS)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= n
    # every row of an image in exactly one CTA, none over the plan's rows
    owner = np.full(n, -1)
    for rank in range(plan.cluster):
        r0, r1 = tfn.cta_rows(n, plan.cluster, rank)
        assert 0 < r1 - r0 <= -(-n // plan.cluster)
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = rank
    assert (owner >= 0).all() and np.all(np.diff(owner) >= 0)
    # threads: whole row lanes of C/8 columns within the row-lane launch's
    # bound, or one row lane on the wide launch
    assert plan.threads % (c // 8) == 0 and plan.threads >= 32
    assert plan.threads <= tfn.MAX_THREADS or plan.threads == c // 8 <= tfn.WIDE_THREADS
    return plan


@pytest.mark.parametrize("shape", SHAPES + EDGE)
def test_plan_covers_every_row_once(shape):
    _check_plan(*shape)


def test_plan_cluster_rule():
    """The smallest cluster whose grid fills the card while a CTA streams
    at most CTA_BYTES, else the largest (16, or the largest power of two at
    most N): at batch 16, 8 CTAs an image where the image is small (N64,
    N256, N1024 x C320 / C640), 16 where it is large; 16 at batch 3."""
    for b, n, c in SHAPES + EDGE:
        plan = tfn.launch_plan(b, n, c, SMS)
        sizes = [s for s in (1, 2, 4, 8, 16) if s <= n]
        ok = [s for s in sizes if b * s >= tfn.FILL * SMS and 2 * c * -(-n // s) <= tfn.CTA_BYTES]
        assert plan.cluster == (ok[0] if ok else sizes[-1])
    small = {(b, n, c) for b, n, c in SHAPES if tfn.launch_plan(b, n, c, SMS).cluster == 8}
    assert small == {(16, 64, 1280), (16, 64, 2560), (16, 256, 640), (16, 256, 1280),
                     (16, 256, 1920), (16, 256, 2560), (16, 1024, 320), (16, 1024, 640)}
    assert all(tfn.launch_plan(3, n, c, SMS).cluster == 16 for _, n, c in SHAPES)


def test_plan_threads_by_grid():
    """About 256 threads a CTA where the grid fills the card (batch 16: 128
    or 256 CTAs), about 512 where it cannot (batch 3: 48 CTAs)."""
    for b, n, c in SHAPES:
        plan = tfn.launch_plan(b, n, c, SMS)
        target = 256 if b * plan.cluster >= tfn.FILL * SMS else 512
        cv = c // 8
        assert abs(plan.threads - target) <= cv / 2 or plan.threads == tfn.MAX_THREADS // cv * cv
    assert tfn.launch_plan(16, 4096, 320, SMS).threads == 240
    assert tfn.launch_plan(3, 4096, 320, SMS).threads == 480
    assert tfn.launch_plan(16, 64, 1280, SMS).threads == 320


def test_edge_shapes_take_every_cluster_size():
    plans = [tfn.launch_plan(*s, SMS) for s in EDGE]
    assert {p.cluster for p in plans} == {1, 2, 4, 8, 16}
    assert any(p.threads > tfn.MAX_THREADS for p in plans)  # the wide launch
    assert any(p.threads % 32 for p in plans)  # a partial warp
    assert any(n % p.cluster for (_, n, _), p in zip(EDGE, plans))  # ragged rows


def test_layout_matches_the_kernel_source():
    """The plan's limits are the kernel's (its C entry refuses the rest)."""
    src = CU.read_text()
    for name in ("MAX_CLUSTER", "MAX_THREADS", "WIDE_THREADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(tfn, name), name


@pytest.mark.parametrize("c", [4096, 4352, 5120, 6144, 8192])
def test_wide_channels_take_one_row_lane(c):
    """C/8 threads a CTA from C 4096 (512 threads) to C 8192 (1024); the
    wrapper takes C up to 8 x WIDE_THREADS."""
    for b, n in ((16, 64), (2, 4096), (1, 8)):
        plan = _check_plan(b, n, c)
        assert plan.threads == c // 8
    assert 8 * tfn.WIDE_THREADS == 8192


def _inputs(rng, b, n, c):
    x = (rng.standard_normal((b, n, c)) * 1.5 + rng.standard_normal(c)
         + np.linspace(-1, 1, n)[None, :, None]).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("b,n,c,cluster", [(2, 64, 320, 16), (2, 64, 320, 8),
                                           (3, 40, 64, 16), (1, 24, 32, 4), (2, 16, 96, 1)])
def test_tree_matches_plain_and_jax(monkeypatch, rng, b, n, c, cluster):
    """Per-CTA partials added in rank order: the same function as the plain
    version and as JAX's Pallas kernel (interpret mode), ragged rows
    included; a peer's partial left out is far outside the tolerance."""
    x, scale, bias = _inputs(rng, b, n, c)
    xt, st, bt = (torch.from_numpy(a) for a in (x, scale, bias))
    parts = tfn.cluster_partials(xt, cluster)
    assert parts.shape == (b, cluster, 2, 32)
    tree = tfn.group_norm_silu_from_partials(xt, st, bt, parts).numpy()
    plain = tfn.group_norm_silu_plain(xt, st, bt).numpy()
    monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", n * c)  # N % 8 == 0: the Pallas kernel
    ref = np.asarray(jfn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), 32, 1e-5, True))
    np.testing.assert_allclose(tree, plain, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tree, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tfn.group_norm_silu_from_partials(xt, st, bt, parts, apply_silu=False).numpy(),
        tfn.group_norm_silu_plain(xt, st, bt, apply_silu=False).numpy(), atol=ATOL, rtol=0)
    if cluster > 1:
        parts[:, -1] = 0
        dropped = tfn.group_norm_silu_from_partials(xt, st, bt, parts).numpy()
        assert np.abs(dropped - plain).max() > 100 * ATOL


def test_partials_sum_each_ctas_rows(rng):
    """Partial k holds the sums over CTA k's rows only."""
    x, _, _ = _inputs(rng, 1, 21, 64)
    parts = tfn.cluster_partials(torch.from_numpy(x), 4).numpy()
    for rank in range(4):
        r0, r1 = tfn.cta_rows(21, 4, rank)
        sl = x[0, r0:r1].astype(np.float64)
        np.testing.assert_allclose(parts[0, rank, 0], sl.sum(0).reshape(32, 2).sum(-1),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(parts[0, rank, 1], (sl * sl).sum(0).reshape(32, 2).sum(-1),
                                   rtol=1e-5, atol=1e-4)
