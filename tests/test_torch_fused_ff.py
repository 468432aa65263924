"""Port parity of the fused LayerNorm + GEGLU feed-forward
(`adaface_tpu_torch.ops.fused_ff`) against `adaface_tpu.ops.fused_ff`, on the
CPU.

With `ADAFACE_FUSED_FF=1` (read at call time on both sides) the JAX function
runs its Pallas kernel `_ff_kernel` in interpret mode and the port, on a CPU
tensor, the kernel's plain version `ln_geglu_ff_plain` (a spy checks it
did). With the knob off the port runs its unfused torch chain, held against
JAX's `_reference_ln_geglu_ff`.

Tolerances (fp32): 2e-5 absolute on outputs of order 1 (x + o with o of
order 0.5; fp32 products summed in other orders in XLA and torch, and the
knob-off arm's LayerNorm takes torch's two-pass variance); gradients 5e-5
absolute against jax.grad."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaface_tpu.ops.fused_ff as jff

from adaface_tpu_torch.ops import fused_ff as tff

torch.set_num_threads(2)

ATOL = 2e-5
GRAD_ATOL = 5e-5


@pytest.fixture
def spy(monkeypatch):
    """Names of the port's arms called: the kernel's plain version and the
    unfused chain."""
    calls = []
    for name in ("ln_geglu_ff_plain", "ln_geglu_ff_unfused"):
        real = getattr(tff, name)
        monkeypatch.setattr(tff, name, lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    return calls


def _inputs(rng, b, l, c):
    """x, LN scale and bias, w1 [C, 8C] (value | gate), b1, w2 [4C, C], b2,
    weights scaled by 1/sqrt(fan-in) so that o is of order 0.5."""
    f = 4 * c
    r = lambda *s: rng.standard_normal(s)
    return tuple(a.astype(np.float32) for a in (
        r(b, l, c) * 2 + 0.5, 1 + 0.2 * r(c), 0.2 * r(c), r(c, 2 * f) / np.sqrt(c),
        0.2 * r(2 * f), r(f, c) / np.sqrt(f), 0.2 * r(c)))


@pytest.mark.parametrize("b,l,c", [(2, 64, 64), (1, 48, 32)])
def test_kernel_function_matches_jax(monkeypatch, spy, rng, b, l, c):
    monkeypatch.setenv("ADAFACE_FUSED_FF", "1")
    args = _inputs(rng, b, l, c)
    ref = np.asarray(jff.ln_geglu_ff(*map(jnp.asarray, args)))
    got = tff.ln_geglu_ff(*map(torch.from_numpy, args)).numpy()
    assert spy == ["ln_geglu_ff_plain"]
    assert np.abs(ref - args[0]).max() > 0.5  # the feed-forward adds something
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_knob_off_unfused_arm_matches_jax_reference(monkeypatch, spy, rng):
    monkeypatch.delenv("ADAFACE_FUSED_FF", raising=False)
    args = _inputs(rng, 2, 64, 64)
    ref = np.asarray(jff._reference_ln_geglu_ff(*map(jnp.asarray, args), 1e-5))
    got = tff.ln_geglu_ff(*map(torch.from_numpy, args)).numpy()
    assert spy == ["ln_geglu_ff_unfused"]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("wrt", ["all", "x only"])
def test_gradients_match_jax(monkeypatch, rng, wrt):
    """The port's autograd Function (backward recomputes the plain chain)
    against jax.grad of the JAX custom_vjp; with only x requiring a gradient
    (the UNet's frozen weights) the weights get none."""
    monkeypatch.setenv("ADAFACE_FUSED_FF", "1")
    args = _inputs(rng, 2, 64, 64)
    w = rng.standard_normal(args[0].shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jff.ln_geglu_ff(*a) * w),
                  argnums=tuple(range(7)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a) for a in args]
    for t in ts if wrt == "all" else ts[:1]:
        t.requires_grad_(True)
    (tff.ln_geglu_ff(*ts) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, jg):
        if t.requires_grad:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=0)
        else:
            assert t.grad is None


def test_bf16_roundings_match_jax_reference(rng):
    """bf16: the plain version keeps `_reference_ln_geglu_ff`'s casts (LN
    output, u after the fp32 product with b1 added after the cast, h, o).
    Against JAX's reference on the same bf16 values it is bit-identical in
    most elements (78% measured; XLA and torch round GELU's internals
    differently, and one flipped rounding of u or h moves o), more than the
    same chain without the intermediate casts (54%) or the unfused torch arm
    (61%) manage; its feed-forward part is within 1e-2 relative L2 (measured
    5.5e-3)."""
    args = _inputs(rng, 2, 64, 64)
    tb = [torch.from_numpy(a).bfloat16() for a in args]
    ref = np.asarray(jff._reference_ln_geglu_ff(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb), 1e-5)
        .astype(jnp.float32))
    same = lambda out: np.mean(out.float().numpy() == ref)
    got = tff.ln_geglu_ff_plain(*tb)
    assert same(got) > 0.7
    assert same(tff.ln_geglu_ff_plain(*[t.float() for t in tb]).bfloat16()) < 0.65
    assert same(tff.ln_geglu_ff_unfused(*tb)) < 0.65
    x = tb[0].float().numpy()
    o, o_ref = got.float().numpy() - x, ref - x
    assert np.linalg.norm(o - o_ref) / np.linalg.norm(o_ref) < 1e-2


def test_cuda_wrapper_refuses_cpu_tensor(rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 1, 8, 64)]
    with pytest.raises(ValueError, match="not a CUDA device"):
        tff.ln_geglu_ff_cuda(*args)


# (M, C, F) of the CUDA kernel's launch plan: the six shapes of the fused
# generate and training paths (B16 L4096 C320, B16 L1024 C640, B16 L256
# C1280, B16 L64 C1280, B3 L4096 C320, B3 L1024 C640), the small-input UNet
# call's (batch 2 at a 16x16 latent: L 256, 64, 16 and the 2x2 middle), and
# other multiples of 64 the wrapper takes (one row, ragged row blocks, F not
# a multiple of 128, C not a multiple of 160, 256-row GEMM2 tiles at other
# widths).
PLAN_SHAPES = [(65536, 320, 1280), (16384, 640, 2560), (4096, 1280, 5120), (1024, 1280, 5120),
               (12288, 320, 1280), (3072, 640, 2560),
               (512, 320, 1280), (128, 640, 2560), (32, 1280, 5120), (8, 1280, 5120),
               (1, 64, 256), (129, 640, 2560), (66, 64, 192), (200, 128, 512),
               (300, 2048, 8192), (3000, 1280, 5120), (9000, 192, 768), (5000, 512, 2048)]


@pytest.mark.parametrize("m,c,f", PLAN_SHAPES)
def test_launch_plan_covers_each_output_and_k_range_once(m, c, f):
    """Both GEMMs' work items, as the persistent kernel walks them, cover
    every row below M, every output column and every 64-column K step
    exactly once; tiles divide their widths, grids hold at most one CTA per
    SM and none idle, and every split has a K step."""
    sms = 132
    plan = tff.launch_plan(m, c, f, sms)
    assert f % plan.bn1 == 0 and c % plan.bn2 == 0 and (c % 160 or plan.bn2 == 160)
    assert 1 <= plan.split <= min(tff.MAX_SPLIT, f // 64) and plan.rows2 in tff.GEMM2_ROWS
    for n, k, rows, bn, split, grid in (
            (f, c, tff.GEMM1_ROWS, plan.bn1, 1, plan.grid1),
            (c, f, plan.rows2, plan.bn2, plan.split, plan.grid2)):
        assert 0 < grid <= sms
        cover = np.zeros((-(-m // rows), n // bn, k // 64), dtype=int)
        per_cta = tff.gemm_items(m, n, k, rows, bn, split, grid)
        assert len(per_cta) == grid and all(per_cta)
        for items in per_cta:
            for it in items:
                assert it.k1 > it.k0 and it.row0 % rows == 0 and it.row0 < m
                cover[it.row0 // rows, it.col0 // bn, it.k0 // 64:it.k1 // 64] += 1
        assert (cover == 1).all()
