"""Port parity of the Winograd F(2x2, 3x3) conv op (`adaface_tpu_torch.ops.
winograd`) against the JAX package's `adaface_tpu.ops.winograd`, whose Pallas
kernel runs in interpret mode here; the port runs the kernel's plain version
on CPU tensors. The CUDA kernel is held against the same plain version on
the card by `chip_smoke.py`.

Tolerances: fp32 1e-5 relative to the output's scale (sums in other orders);
bf16: the plain version reproduces the kernel's roundings (the input
transform rounded after every add, fp32 products and output sums, one final
cast), so the outputs agree bit for bit in at least 99% of the elements
and within one bf16 ulp of the output's scale elsewhere (fp32 sums in other
orders can move a value across a rounding boundary); gradients 1e-4 of
their scale (the direct conv's VJP on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.ops import winograd as jw
from adaface_tpu_torch.ops import winograd as tw

torch.set_num_threads(2)

# (B, H, W, Cin, Cout): square and not, lane-wide and the UNet's in-conv
# (Cin 4) and out-conv (Cout 4)
SHAPES = [(2, 8, 8, 128, 128), (1, 16, 8, 192, 64), (1, 6, 10, 4, 32), (2, 8, 6, 48, 4)]


def _case(rng, shape, dtype=np.float32):
    b, h, w, cin, cout = shape
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    return x, k, bias


def _to(arrays, dtype):
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32) for a in j]
    return j, t


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_transform_weights_matches_jax(rng, dtype):
    k = rng.standard_normal((3, 3, 24, 40)).astype(np.float32)
    (jk,), (tk,) = _to([k], dtype)
    ref = np.asarray(jw.transform_weights(jk).astype(jnp.float32))
    got = tw.transform_weights(tk)
    assert got.dtype == tk.dtype and got.shape == (16, 24, 40)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_fp32(rng, shape):
    x, k, bias = _case(rng, shape)
    ref = np.asarray(jw.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    got = tw.winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(k),
                              torch.from_numpy(bias)).numpy()
    assert got.shape == ref.shape == shape[:3] + (shape[4],)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)
    # and it is the conv
    direct = tw.direct_conv3x3(*(torch.from_numpy(a) for a in (x, k, bias))).numpy()
    np.testing.assert_allclose(got, direct, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_bf16(rng, shape):
    x, k, bias = _case(rng, shape)
    (jx, jk, jb), (tx, tk, tb) = _to([x, k, bias], jnp.bfloat16)
    ref = np.asarray(jw.winograd_conv3x3(jx, jk, jb).astype(jnp.float32))
    got = tw.winograd_conv3x3(tx, tk, tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(ref).max()
    assert np.mean(got == ref) >= 0.99
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * scale)


def test_transform_rounds_after_every_add(rng):
    """The bf16 input transform rounds after each of its three adds, as XLA
    does for the TPU kernel: rounding once at the end gives other t values,
    and other outputs, in a large share of the elements."""
    x, k, bias = _case(rng, (2, 8, 8, 64, 64))
    (jx, jk, jb), (tx, tk, tb) = _to([x, k, bias], jnp.bfloat16)
    ref = np.asarray(jw.winograd_conv3x3(jx, jk, jb).astype(jnp.float32))
    got = tw.winograd_conv3x3(tx, tk, tb).float().numpy()
    once = tw.winograd_conv3x3_plain(tx.float(), tw.transform_weights(tk).float(), tb.float())
    # an fp32 transform, then the products of its bf16 rounding
    tile = tw._input_tiles(tx.float())
    t = tile(0, 0) - tile(0, 2) - tile(2, 0) + tile(2, 2)  # position (0, 0)
    t_rounded_once = t.bfloat16().float()
    t_chain = tw._input_transform(tw._input_tiles(tx), 0, 0)
    assert t_chain.dtype == torch.bfloat16
    assert (t_chain.float() != t_rounded_once).float().mean() > 0.1
    assert np.mean(got == ref) > np.mean(once.bfloat16().float().numpy() == ref)


MODES = [("0", {}), ("1", {}), ("auto", {}), ("auto", {"ADAFACE_WINOGRAD_MIN_TILES": "16"}),
         ("1", {"ADAFACE_WINOGRAD_VMEM": str(8 * 1024 * 1024)}), ("yes", {})]
ELIGIBLE_SHAPES = [((16, 64, 64, 320), 320), ((8, 64, 64, 4), 320), ((16, 64, 64, 320), 4),
                   ((16, 32, 32, 640), 640), ((16, 8, 8, 2560), 1280),
                   ((16, 8, 8, 1280), 1280), ((2, 16, 16, 128), 128), ((1, 7, 8, 128), 128),
                   ((1, 32, 32, 96), 128), ((16, 16, 16, 1920), 1280)]


@pytest.mark.parametrize("mode,env", MODES)
def test_eligibility_matches_jax(monkeypatch, mode, env):
    monkeypatch.setenv("ADAFACE_WINOGRAD", mode)
    for name in ("ADAFACE_WINOGRAD_MIN_TILES", "ADAFACE_WINOGRAD_VMEM"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for shape, cout in ELIGIBLE_SHAPES:
        for itemsize in (2, 4):
            assert (tw.winograd_eligible(shape, cout, itemsize)
                    == jw.winograd_eligible(shape, cout, itemsize)), (shape, cout, itemsize)
            h, w, cin = shape[1:]
            assert tw.vmem_estimate(h, w, cin, cout, itemsize) == jw._vmem_estimate(
                h, w, cin, cout, itemsize)


@pytest.mark.parametrize("mode,enabled,want", [("0", True, 0), ("1", True, 1),
                                               ("1", False, 0), ("auto", True, 0)])
def test_conv3x3_same_dispatch(monkeypatch, rng, mode, enabled, want):
    """The op where the gates pass (the kernel's plain version on the CPU),
    else the direct conv; the same output as JAX's `conv3x3_same`, with and
    without a bias."""
    monkeypatch.setenv("ADAFACE_WINOGRAD", mode)
    calls = []
    real = tw.winograd_conv3x3_plain
    monkeypatch.setattr(tw, "winograd_conv3x3_plain",
                        lambda *a: calls.append(1) or real(*a))
    x, k, bias = _case(rng, (1, 8, 8, 32, 32))
    for b in (bias, None):
        ref = np.asarray(jw.conv3x3_same(jnp.asarray(x), jnp.asarray(k),
                                         None if b is None else jnp.asarray(b), enabled))
        got = tw.conv3x3_same(torch.from_numpy(x), torch.from_numpy(k),
                              None if b is None else torch.from_numpy(b), enabled).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    assert len(calls) == 2 * want


def test_gradients_match_jax(rng):
    x, k, bias = _case(rng, (2, 8, 6, 16, 24))
    w = rng.standard_normal((2, 8, 6, 24)).astype(np.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(jw.winograd_conv3x3(a, b, c) * jnp.asarray(w)),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, k, bias)))
    tx, tk, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, bias))
    out = tw.winograd_conv3x3(tx, tk, tb)
    assert type(out.grad_fn).__name__ == "WinogradConv3x3Backward"
    (out * torch.from_numpy(w)).sum().backward()
    for name, g, r in zip(("dx", "dkernel", "dbias"), (tx, tk, tb), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.grad.numpy(), r, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16)
    u = torch.zeros((16, 32, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tw.winograd_conv3x3_cuda(x, u, torch.zeros(32, dtype=torch.bfloat16))


def test_padded_weights_tile_multiples():
    u = torch.randn(16, 4, 36)
    up = tw.padded_weights(u)  # K-major [16, Cout_p, Cin_p], both multiples of 64
    assert up.shape == (16, 64, 64)
    torch.testing.assert_close(up[:, :36, :4], u.transpose(1, 2), rtol=0, atol=0)
    assert up[:, 36:].abs().sum() == 0 and up[:, :, 4:].abs().sum() == 0
