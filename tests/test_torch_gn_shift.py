"""`ADAFACE_GN_SHIFT` in the port's `group_norm` against the JAX package's,
fp32 on the CPU, outputs and gradients (`jax.grad` vs autograd).

Under `GN_SHIFT=1` both subtract the per-group probe (the group mean of the
first spatial position, no gradient) before the one-pass sums. On an input
with a large common-mode offset (3000, std 1) the raw form loses the group
variance to fp32 cancellation, so a port that ignores the knob is off by
orders of magnitude; with the shift both agree with a float64 reference to
about 1e-4. The default (raw) form is held against JAX on an ordinary input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.ops.basic import group_norm as jax_group_norm
from adaface_tpu_torch.ops.basic import group_norm

torch.set_num_threads(2)

SHAPE = (2, 16, 16, 64)
GROUPS = 32
EPS = 1e-5


def _inputs(offset):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(SHAPE) + offset).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(SHAPE[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(SHAPE[-1])).astype(np.float32)
    w = rng.standard_normal(SHAPE).astype(np.float32)  # cotangent of the output
    return x, scale, bias, w


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax(x, scale, bias, w):
    def loss(x, s, b):
        return jnp.sum(jax_group_norm(x, s, b, num_groups=GROUPS, eps=EPS) * w)

    out = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         num_groups=GROUPS, eps=EPS)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(x, scale, bias, w):
    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    out = group_norm(xt, st, bt, num_groups=GROUPS, eps=EPS)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (xt, st, bt)]


def _fp64_reference(x, scale, bias):
    b, c = SHAPE[0], SHAPE[-1]
    x64 = x.astype(np.float64).reshape(b, -1, GROUPS, c // GROUPS)
    mu = x64.mean(axis=(1, 3), keepdims=True)
    var = x64.var(axis=(1, 3), keepdims=True)
    y = ((x64 - mu) / np.sqrt(var + EPS)).reshape(SHAPE)
    return y * scale.astype(np.float64) + bias.astype(np.float64)


def test_gn_shift_matches_jax_on_a_large_offset(monkeypatch):
    """Offset 3000: relative L2 of the port against JAX <= 1e-3 for the
    output (both shifted, fp32 sums in other orders; each reads ~1.3e-4 from
    the float64 reference) and the x and bias gradients, 5e-3 for the scale
    gradient. That one is a difference of two sums ~3000 times larger than
    itself, so fp32 leaves ~1e-3 of it: against the float64 value JAX reads
    1.5e-3, the port 5e-4. A port without the shift reads ~2e2."""
    monkeypatch.setenv("ADAFACE_GN_SHIFT", "1")
    x, scale, bias, w = _inputs(3000.0)
    ref_out, ref_grads = _jax(x, scale, bias, w)
    out, grads = _port(x, scale, bias, w)
    assert _rel(out, _fp64_reference(x, scale, bias)) <= 1e-3
    assert _rel(out, ref_out) <= 1e-3
    for name, g, rg, tol in zip(("x", "scale", "bias"), grads, ref_grads,
                                (1e-3, 5e-3, 1e-3)):
        assert _rel(g, rg) <= tol, name
    yhat = _fp64_reference(x, np.ones_like(scale), np.zeros_like(bias))
    assert _rel(grads[1], (yhat * w).sum(axis=(0, 1, 2))) <= 5e-3
    assert 0.9 < float(np.std(out)) < 1.2  # not collapsed to rsqrt(eps)


def test_gn_shift_is_read_at_call_time(monkeypatch):
    """One process, the knob flipped between two calls: the raw form cancels
    on the offset input, the shifted one does not."""
    x, scale, bias, _ = _inputs(3000.0)
    args = (torch.tensor(x), torch.tensor(scale), torch.tensor(bias))
    ref = _fp64_reference(x, scale, bias)
    monkeypatch.delenv("ADAFACE_GN_SHIFT", raising=False)
    raw = group_norm(*args, num_groups=GROUPS, eps=EPS).numpy()
    monkeypatch.setenv("ADAFACE_GN_SHIFT", "1")
    shifted = group_norm(*args, num_groups=GROUPS, eps=EPS).numpy()
    assert _rel(shifted, ref) <= 1e-3
    assert _rel(raw, ref) > 1.0


@pytest.mark.parametrize("knob", [None, "0"])
def test_group_norm_default_matches_jax(monkeypatch, knob):
    """The raw one-pass form (knob unset or not "1") on an input without an
    offset: port against JAX at relative L2 <= 1e-5, outputs and gradients
    (the same fp32 arithmetic, sums in other orders)."""
    if knob is None:
        monkeypatch.delenv("ADAFACE_GN_SHIFT", raising=False)
    else:
        monkeypatch.setenv("ADAFACE_GN_SHIFT", knob)
    x, scale, bias, w = _inputs(0.5)
    ref_out, ref_grads = _jax(x, scale, bias, w)
    out, grads = _port(x, scale, bias, w)
    assert _rel(out, ref_out) <= 1e-5
    for name, g, rg in zip(("x", "scale", "bias"), grads, ref_grads):
        assert _rel(g, rg) <= 1e-5, name
