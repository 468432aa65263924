"""Port parity of the fused GroupNorm+SiLU (`adaface_tpu_torch.ops.fused_norm`)
against `adaface_tpu.ops.fused_norm`, on the CPU.

The JAX side runs its Pallas kernel `_gn_silu_kernel` in interpret mode.
Its threshold `_MAX_BLOCK_ELEMS` is read once, at import, so the tests set
the module attribute; the port reads `ADAFACE_GN_MAX_ELEMS` at call time, so
they set the environment. On a CPU tensor that passes the gates the port
runs the kernel's plain version `group_norm_silu_plain` (a spy checks it did);
a slab that fails a gate takes `_plain` on both sides.

Tolerances (fp32): 2e-5 absolute on outputs of order 1, since the JAX kernel
sums channels into groups with an fp32 matrix product and torch sums them in
another order; gradients 5e-5 absolute against jax.grad for the same reason.
In bf16 the two arms differ by one rounding (SiLU before or after the cast),
so that test compares in units of one bf16 rounding step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaface_tpu.ops.fused_norm as jfn

from adaface_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(2)

ATOL = 2e-5
GRAD_ATOL = 5e-5


@pytest.fixture
def spy(monkeypatch):
    """Counts the port's calls of the kernel's plain version."""
    calls = []
    real = tfn.group_norm_silu_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tfn, "group_norm_silu_plain", counted)
    return calls


def _inputs(rng, shape):
    c = shape[-1]
    # a per-channel offset and a ramp over the rows: group statistics that a
    # wrong reduction would get visibly wrong
    x = (rng.standard_normal(shape) * 1.5 + rng.standard_normal(c)
         + np.linspace(-1, 1, int(np.prod(shape[1:-1])))
         .reshape((1,) + shape[1:-1] + (1,))).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _run_both(x, scale, bias, silu=True, groups=32):
    ref = jfn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              groups, 1e-5, silu)
    got = tfn.group_norm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), groups, 1e-5, silu)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("shape,silu", [((2, 8, 8, 320), True), ((2, 16, 16, 64), True),
                                        ((2, 8, 8, 96), False)])
def test_kernel_function_matches_jax(monkeypatch, spy, rng, shape, silu):
    """[2, 8, 8, 320] (groups of 10 channels, a UNet width) and tiny-UNet
    shapes; the JAX Pallas kernel in interpret mode."""
    n_c = int(np.prod(shape[1:]))
    monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", n_c)
    monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", str(n_c))
    ref, got = _run_both(*_inputs(rng, shape), silu=silu)
    assert spy == [shape]
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["n % 8", "c % groups", "over threshold", "knob unset"])
def test_fallback_gates_match_jax_plain(monkeypatch, spy, rng, case):
    """Each gate of the JAX function sends the slab to `_plain` on both
    sides (the port's spy sees no call), against JAX's `_plain`."""
    shape, groups, limit = {
        "n % 8": ((2, 3, 5, 64), 32, 10 ** 9),        # N = 15
        "c % groups": ((2, 8, 8, 48), 32, 10 ** 9),   # 48 channels, 32 groups
        "over threshold": ((2, 8, 8, 64), 32, 64 * 64 - 1),
        "knob unset": ((2, 8, 8, 64), 32, None),
    }[case]
    if limit is None:
        monkeypatch.delenv("ADAFACE_GN_MAX_ELEMS", raising=False)
        monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", 0)
    else:
        monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", str(limit))
        monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", limit)
    x, scale, bias = _inputs(rng, shape)
    plain = lambda: np.asarray(jfn._plain(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(bias), groups, 1e-5, True))
    if case == "c % groups":
        # `_plain` cannot split 48 channels into 32 groups either: both raise
        with pytest.raises(TypeError):
            plain()
        with pytest.raises(RuntimeError):
            tfn.group_norm_silu(*(torch.from_numpy(a) for a in (x, scale, bias)), groups)
    else:
        _, got = _run_both(x, scale, bias, groups=groups)
        np.testing.assert_allclose(got, plain(), atol=ATOL, rtol=0)
    assert spy == []


def test_knob_read_at_call_time(monkeypatch, spy, rng):
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, (1, 8, 8, 64)))
    monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", "0")
    tfn.group_norm_silu(x, scale, bias)
    monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", str(8 * 8 * 64))
    tfn.group_norm_silu(x, scale, bias)
    assert spy == [(1, 8, 8, 64)]


@pytest.mark.parametrize("wrt", ["x, scale, bias", "x only"])
def test_gradients_match_jax(monkeypatch, rng, wrt):
    """The port's autograd Function (backward recomputes `_plain`) against
    jax.grad of the JAX custom_vjp, for a weighted sum of the output."""
    shape = (2, 8, 8, 64)
    monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", 8 * 8 * 64)
    monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", str(8 * 8 * 64))
    x, scale, bias = _inputs(rng, shape)
    w = rng.standard_normal(shape).astype(np.float32)
    jg = jax.grad(lambda a, s, b: jnp.sum(jfn.group_norm_silu(a, s, b) * w),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ts = [torch.from_numpy(a) for a in (x, scale, bias)]
    for t in ts if wrt != "x only" else ts[:1]:
        t.requires_grad_(True)
    (tfn.group_norm_silu(*ts) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, jg):
        if t.requires_grad:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=0)
        else:
            assert t.grad is None


def test_bf16_silu_before_cast(monkeypatch, rng):
    """bf16 input: the kernel's function applies SiLU in fp32 and casts once;
    the fallback casts the GroupNorm output and applies SiLU to the bf16
    value. The two differ, by at most one bf16 rounding step of the output
    plus one of the GroupNorm value; each agrees with its JAX counterpart
    to within one step of the output (two for the fallback, whose JAX SiLU
    rounds twice)."""
    shape = (2, 8, 8, 320)
    monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", 8 * 8 * 320)
    x, scale, bias = _inputs(rng, shape)
    xb = torch.from_numpy(x).bfloat16()
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    kern = tfn.group_norm_silu_plain(xb, s, b).float()
    fall = tfn._plain(xb, s, b, 32, 1e-5, True).float()
    gn = tfn.group_norm_silu_plain(xb.float(), s, b, apply_silu=False)

    def step(v):  # one bf16 step at |v| (8 significant bits)
        return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)

    d = (kern - fall).abs()
    assert d.max() > 0
    assert bool((d <= 1.01 * (step(kern) + step(gn)) + 1e-30).all())
    step = step(kern)
    # fp32 compute, one cast: exactly the fp32 function rounded
    torch.testing.assert_close(kern, tfn.group_norm_silu_plain(xb.float(), s, b)
                               .bfloat16().float(), rtol=0, atol=0)
    xj = jnp.asarray(np.asarray(xb.float())).astype(jnp.bfloat16)
    jk = np.asarray(jfn.group_norm_silu(xj, jnp.asarray(scale), jnp.asarray(bias))
                    .astype(jnp.float32))
    jp = np.asarray(jfn._plain(xj, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, True)
                    .astype(jnp.float32))
    assert np.all(np.abs(kern.numpy() - jk) <= step.numpy() * 1.01 + 1e-30)
    assert np.all(np.abs(fall.numpy() - jp) <= 2 * step.numpy() + 1e-30)


def test_rows_per_chunk():
    """The kernel's row split (`launch_plan`, `cta_rows`): an image's rows
    go to the CTAs of one cluster in order, in shares that differ by at
    most one row, and each CTA holds at most ceil(N / cluster) of them."""
    for c in (320, 640, 960, 1280, 1920, 2560):
        for b, n in ((16, 64), (16, 256), (3, 1024), (16, 4096), (2, 1001)):
            plan = tfn.launch_plan(b, n, c, 132)
            bounds = [tfn.cta_rows(n, plan.cluster, k) for k in range(plan.cluster)]
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a[1] == nxt[0] for a, nxt in zip(bounds, bounds[1:]))
            sizes = {r1 - r0 for r0, r1 in bounds}
            assert max(sizes) == -(-n // plan.cluster) and max(sizes) - min(sizes) <= 1


def test_cuda_wrapper_refuses_cpu_tensor(rng):
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, (1, 8, 8, 64)))
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfn.group_norm_silu_cuda(x, scale, bias)
