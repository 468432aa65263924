"""The fp32 Winograd kernel's CUDA source (`csrc/winograd_fp32.cu`) run on the
CPU: compiled by the host C++ compiler against `tests/cuda_emu.h` (one
std::thread per CUDA thread, barriers, cp.async landing at the wait or at
issue) and called through its C entry on every path (general, narrow in,
narrow out) with the wrapper's plan and with forced plans, against
`winograd_conv3x3_plain` from numpy inputs made from a seed, and at one shape
against the JAX package's `winograd_conv3x3` (its Pallas kernel in interpret
mode).

This checks what the kernel's text decides (the paths, the general tiles,
the per-thread cp.async ring, the transposed stages and their one barrier,
ragged rows and columns, the quadrant folds at a slice's edge, the split's
partials and their sum, the narrow paths' channel groups and warp slices),
not the card: registers, spills and timing are `chip_smoke.py` phase 4h's.
Both planted faults of 4h (`FP32_FAULTS["wino"]`, a position left out of the
general path; `FP32_FAULTS["wino_narrow"]`, a position left out of the
narrow paths) must fail here too. Tolerance: 4h's fp32 gate, 1e-5 relative L2 and 1e-5 of the largest value (fp32 sums in other orders than
the CPU's matmul). The plan's work items, the public op's weight layout
cache and the fp32 split's plain version are checked without a compiler. The
emulated part is skipped where no host C++ compiler is installed."""

import ctypes
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import kernel_variants as kv
import wino_variants
from adaface_tpu.ops import winograd as jw
from adaface_tpu_torch.ops import winograd as tw
from test_torch_ff_fp32_emulated import _emulated

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "winograd_fp32.cu"
ENTRY = "winograd_conv3x3_fp32_fwd"
SMS = 132  # H100 SXM
GEN, NIN, NOUT = tw.FP32_GENERAL, tw.FP32_NARROW_IN, tw.FP32_NARROW_OUT


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """name -> the emulated C entry: the source ("base") and 4h's planted
    faults ("wino", "wino_narrow"), compiled side by side against one
    emulated copy of the shared header; "land" sets when base's copies
    land."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("wino_fp32_emu")
    shutil.copy(os.path.join(HERE, "cuda_emu.h"), out)
    header = open(os.path.join(kv.CSRC, "ffma_tile.cuh")).read()
    (out / "ffma_tile.cuh").write_text(_emulated(
        header, ["cp_async16", "cp_async_commit"]))
    srcs = {"base": open(os.path.join(kv.CSRC, SOURCE)).read()}
    for key in ("wino", "wino_narrow"):
        source, _, _, patches = chip_smoke.FP32_FAULTS[key]
        srcs[key] = kv.patched_sources(kv.CSRC, source, patches)["kernel.cu"]
    procs = {}
    for name, text in srcs.items():
        fence = 'void compiler_fence() { asm volatile("" ::: "memory"); }'
        assert fence in text
        text = _emulated(text.replace(fence, "void compiler_fence() {}"), ["cp_async_wait_ring"])
        # the launches without a barrier or a copy run their threads in turn
        for kernel in ("wino_input_fp32", "wino32_split_sum"):
            text = text.replace(f"LAUNCH({kernel},", f"LAUNCH_SEQ({kernel},")
        (out / f"{name}.cpp").write_text(text)
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
             "-Wno-unknown-pragmas", "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"{name} did not compile:\n{log[-4000:]}"
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = tw.C_ENTRIES[ENTRY][1]
        fn.restype = ctypes.c_int
        built[name] = fn
        if name == "base":
            lib.emu_set_land.argtypes = [ctypes.c_int]
            built["land"] = lib.emu_set_land
    return built


def _case(seed, shape):
    """x, the HWIO kernel and the bias from numpy."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    return x, k, bias


def _run(fn, case, plan):
    """out from the emulated C entry under `plan`; out, V and the split's
    workspace start as NaN, so an element left unwritten shows."""
    x, k, bias = (torch.from_numpy(a) for a in case)
    b, h, w, cin = x.shape
    cout = bias.shape[0]
    m = b * h * w // 4
    ut = tw.padded_weights_fp32(tw.transform_weights(k))
    cin_p = ut.shape[2]
    nan = lambda *shape: torch.full(shape, float("nan"))
    out, v, ws = nan(b, h, w, cout), nan(16, m, cin_p), nan(max(plan.split, 1), 4, m, cout)
    rc = fn(x.data_ptr(), ut.data_ptr(), bias.data_ptr(), v.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, h, w, cin, cout, cin_p, *plan, None)
    assert rc == 0, (rc, plan)
    return out


def _plain(case):
    x, k, bias = (torch.from_numpy(a) for a in case)
    return tw.winograd_conv3x3_plain(x, tw.transform_weights(k), bias)


def _passes(out, plain):
    err, rel = chip_smoke.fused_fp32_errors(out, plain)
    return err <= chip_smoke.FP32_ABS_TOL and rel <= chip_smoke.FP32_REL_TOL


# (B, H, W, Cin, Cout, forced plan or None: the wrapper's): the narrow in
# path at Cin 4 with ragged tile blocks and column groups; the narrow out
# path at Cin not a multiple of 16 or of the team's 8 lanes; the general
# path at ragged M, Cin not a multiple of BK, Cout not a multiple of 4 or of
# the tile, splits, and at Cin 8 / Cin 4 / Cout 4 / Cin 3
CASES = [((1, 10, 26, 4, 70), None), ((2, 6, 8, 8, 40), None), ((1, 8, 8, 4, 4), None),
         ((1, 8, 10, 36, 4), None), ((2, 6, 8, 20, 8), None),
         ((1, 10, 12, 20, 70), None), ((2, 6, 10, 48, 64), tw.FP32Plan(GEN, 1)),
         ((1, 18, 16, 24, 36), tw.FP32Plan(GEN, 3)),
         ((1, 8, 8, 4, 36), tw.FP32Plan(GEN, 1)),
         ((1, 8, 8, 32, 4), tw.FP32Plan(GEN, 2)), ((2, 4, 6, 3, 17), None)]


# (case, land): every case with cp.async copies landing when waited for (a
# read before the wait sees garbage), the general ones also landing at once
# (a slot refilled before its reader is done shows)
RUNS = [(c, 0) for c in CASES] + [
    (c, 1) for c in CASES if tw.fp32_path(c[0][3], c[0][4]) == GEN or c[1] is not None]


@pytest.mark.parametrize("case,land", RUNS, ids=[
    "B{}_{}x{}_Cin{}_Cout{}_".format(*c[0]) + ("plan" if c[1] is None else
                                                "p{}s{}".format(*c[1]))
    + ("_land_at_issue" if land else "_land_at_wait") for c, land in RUNS])
def test_kernel_matches_plain(libs, case, land):
    shape, plan = case
    b, h, w, cin, cout = shape
    data = _case(sum(shape), shape)
    plan = plan or tw.fp32_launch_plan(b * h * w // 4, cin, cout, SMS)
    assert tw.fp32_plan_ok(plan, cin, cout)
    libs["land"](land)
    out = _run(libs["base"], data, plan)
    assert torch.isfinite(out).all()
    plain = _plain(data)
    assert _passes(out, plain), chip_smoke.fused_fp32_errors(out, plain)


def test_kernel_matches_jax(libs):
    """The general path and the narrow in path against JAX's op, its Pallas
    kernel in interpret mode."""
    libs["land"](0)
    for shape, plan in [((1, 8, 6, 24, 20), tw.FP32Plan(GEN, 2)),
                        ((1, 6, 8, 4, 36), tw.FP32Plan(NIN, 1))]:
        data = _case(3, shape)
        ref = torch.from_numpy(np.array(jw.winograd_conv3x3(*(jnp.asarray(a) for a in data))))
        out = _run(libs["base"], data, plan)
        assert _passes(out, ref), chip_smoke.fused_fp32_errors(out, ref)


# every forced split: the general path's slices of its steps (Cin 20: 32)
SPLITS = [((1, 8, 6, 20, 24), tw.FP32Plan(GEN, s)) for s in range(1, tw.FP32_MAX_SPLIT + 1)]


@pytest.mark.parametrize("shape,plan", SPLITS, ids=[
    "p{}s{}".format(*p) for _, p in SPLITS])
def test_every_split_matches_plain(libs, shape, plan):
    """Each forced split within the gate; a split is summed in slice order,
    so a repeat agrees bit for bit."""
    data = _case(plan.split, shape)
    libs["land"](0)
    out = _run(libs["base"], data, plan)
    plain = _plain(data)
    assert _passes(out, plain), chip_smoke.fused_fp32_errors(out, plain)
    if plan.split in (3, 5):
        assert torch.equal(out, _run(libs["base"], data, plan))


@pytest.mark.parametrize("cin", [8, 12, 28, 36, 68, 100])
def test_narrow_out_channel_groups_match_plain(libs, cin):
    """The narrow out path's team of 8 lanes at 2, 3, 7, 9, 17 and 25
    channel groups of 4: fewer groups than lanes, a last round that leaves
    lanes idle, several rounds; a repeat agrees bit for bit."""
    shape = (2, 6, 10, cin, 4)
    data = _case(cin, shape)
    libs["land"](0)
    plan = tw.fp32_launch_plan(2 * 6 * 10 // 4, cin, 4, SMS)
    assert plan == tw.FP32Plan(NOUT, 1)
    out = _run(libs["base"], data, plan)
    plain = _plain(data)
    assert _passes(out, plain), chip_smoke.fused_fp32_errors(out, plain)
    assert torch.equal(out, _run(libs["base"], data, plan))


@pytest.mark.parametrize("key,shape,plan", [
    ("wino", (1, 8, 6, 20, 24), tw.FP32Plan(GEN, 1)),
    ("wino", (1, 8, 6, 20, 24), tw.FP32Plan(GEN, 3)),
    ("wino_narrow", (1, 6, 8, 4, 36), tw.FP32Plan(NIN, 1)),
    ("wino_narrow", (1, 6, 8, 32, 4), tw.FP32Plan(NOUT, 1))])
def test_planted_faults_fail_the_gate(libs, key, shape, plan):
    data = _case(9, shape)
    assert not _passes(_run(libs[key], data, plan), _plain(data)), chip_smoke.FP32_FAULTS[key][2]


def test_entry_refuses_plans_it_does_not_take(libs):
    data = _case(0, (1, 8, 8, 20, 24))
    x, k, bias = (torch.from_numpy(a) for a in data)
    ut = tw.padded_weights_fp32(tw.transform_weights(k))
    v, ws, out = torch.empty(16 * 16 * 32), torch.empty(17 * 4 * 16 * 24), torch.empty(8 * 8 * 24)
    ptrs = [t.data_ptr() for t in (x, ut, bias, v, ws, out)]
    dims = [1, 8, 8, 20, 24, 32]
    for plan in [(GEN, 0), (GEN, 17), (NIN, 1), (NOUT, 1), (3, 1)]:
        assert not tw.fp32_plan_ok(tw.FP32Plan(*plan), 20, 24), plan
        assert libs["base"](*ptrs, *dims, *plan, None) != 0, plan
    assert libs["base"](*ptrs[:4], None, ptrs[5], *dims, GEN, 2, None) != 0  # no ws
    assert libs["base"](*ptrs[:3], None, *ptrs[4:], *dims, GEN, 1, None) != 0  # no V
    assert libs["base"](*ptrs, 1, 8, 8, 20, 24, 48, GEN, 1, None) != 0  # not Cin's layout
    assert libs["base"](ptrs[0] + 4, *ptrs[1:], *dims, GEN, 1, None) != 0  # misaligned
    # a narrow path with a split, the narrow out path at Cin 6 (float4 of
    # x) and at Cout 8, the narrow in path at Cin 8
    assert libs["base"](*ptrs, 1, 8, 8, 36, 4, 48, NOUT, 8, None) != 0
    assert libs["base"](*ptrs, 1, 8, 8, 4, 24, 16, NIN, 2, None) != 0
    assert libs["base"](*ptrs, 1, 8, 8, 6, 4, 16, NOUT, 1, None) != 0
    assert libs["base"](*ptrs, 1, 8, 8, 36, 8, 48, NOUT, 1, None) != 0
    assert libs["base"](*ptrs, 1, 8, 8, 8, 24, 16, NIN, 1, None) != 0
    for plan in [(NOUT, 8), (NIN, 2)]:
        assert not tw.fp32_plan_ok(tw.FP32Plan(*plan), 36 if plan[0] == NOUT else 4,
                                   4 if plan[0] == NOUT else 24), plan


# ------------------------------------------------------------ no compiler
# (B, H, W, Cin, Cout) of the 15 3x3 conv shapes of a generate UNet call
UNET_SHAPES = wino_variants.SHAPES
# (M, Cin, Cout): ragged row blocks, channels that are no tile multiple
RAGGED = [(1, 20, 24), (100, 130, 70), (129, 64, 64), (300, 320, 200), (1000, 48, 1280)]


def _covered_once(m, cin, cout, split):
    """The general path's work items cover every (row block, column block,
    position, channel step) once, each slice a range of steps."""
    nk = tw.fp32_steps(cin) // 16
    rows, cols = tw.FP32_ROWS, tw.FP32_N_TILE
    mblk, nblk = -(-m // rows), -(-cout // cols)
    items = tw.fp32_plan_items(m, cin, cout, split)
    assert len(items) == mblk * nblk * split
    seen = {}
    for it in items:
        assert it.row0 % rows == 0 and it.row0 < m
        assert it.col0 % cols == 0 and it.col0 < cout
        assert 0 <= it.k0 < it.k1 <= 16 * nk and 0 <= it.slice < split
        for st in range(it.k0, it.k1):
            key = (it.row0, it.col0, st // nk, st % nk)
            seen[key] = seen.get(key, 0) + 1
    want = set(itertools.product(range(0, mblk * rows, rows), range(0, nblk * cols, cols),
                                 range(16), range(nk)))
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("shape", UNET_SHAPES)
def test_plan_paths_and_coverage_unet(shape):
    """Cin 4 takes the narrow in path, Cout 4 the narrow out path, the rest
    the general one, whose items cover every step once under the plan."""
    b, h, w, cin, cout = shape
    m = b * h * w // 4
    plan = tw.fp32_launch_plan(m, cin, cout, SMS)
    assert tw.fp32_plan_ok(plan, cin, cout)
    want = NIN if cin == 4 else NOUT if cout == 4 else GEN
    assert plan.path == want
    if plan.path == GEN:
        _covered_once(m, cin, cout, plan.split)


@pytest.mark.parametrize("mcc", RAGGED)
def test_plan_covers_every_step_once_ragged(mcc):
    m, cin, cout = mcc
    plan = tw.fp32_launch_plan(m, cin, cout, SMS, path=GEN)
    for split in sorted({1, 2, 3, plan.split, min(tw.fp32_steps(cin), tw.FP32_MAX_SPLIT)}):
        _covered_once(m, cin, cout, split)


def test_plan_splits_only_where_sms_idle():
    """A split only where the unsplit tiles' last wave leaves SMs idle; the
    small-M C1280 shapes split; a grid of whole waves never does."""
    for b, h, w, cin, cout in UNET_SHAPES:
        m = b * h * w // 4
        plan = tw.fp32_launch_plan(m, cin, cout, SMS)
        if plan.path != GEN or plan.split == 1:
            continue
        tiles = -(-m // tw.FP32_ROWS) * -(-cout // tw.FP32_N_TILE)
        assert tiles % SMS, (b, h, w, cin, cout)
    for shape in [(16, 8, 8, 1280, 1280), (16, 16, 16, 1280, 1280)]:
        b, h, w, cin, cout = shape
        assert tw.fp32_launch_plan(b * h * w // 4, cin, cout, SMS).split > 1, shape
    for waves in (1, 2, 5):
        assert tw.fp32_launch_plan(waves * SMS * tw.FP32_ROWS, 640, 64, SMS).split == 1


def test_narrow_plans_and_paths():
    assert tw.fp32_launch_plan(16384, 320, 4, SMS) == tw.FP32Plan(NOUT, 1)
    assert tw.fp32_launch_plan(100, 4, 320, SMS) == tw.FP32Plan(NIN, 1)
    assert tw.fp32_path(12, 4) == NOUT and tw.fp32_path(8, 4) == NOUT
    assert tw.fp32_path(4, 4) == NIN
    for cin, cout in [(3, 4), (6, 4), (16, 16), (12, 8), (8, 320)]:
        assert tw.fp32_path(cin, cout) == GEN, (cin, cout)


@pytest.mark.parametrize("shape,split", [((1, 8, 6, 20, 24), 5), ((2, 6, 4, 4, 36), 16)])
def test_fp32_split_plain_matches_plain_and_jax(shape, split):
    """The fp32 step width (16 channels) in the split's plain version: the
    slices summed in order agree with the unsplit plain version and with
    JAX's op."""
    x, k, bias = _case(split, shape)
    ref = np.asarray(jw.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    u = tw.transform_weights(torch.from_numpy(k))
    parts = tw.split_partials(tx, u, split, k_tile=tw.FP32_BK)
    assert parts.shape == (split, 2, 2, x.shape[0] * x.shape[1] * x.shape[2] // 4, shape[4])
    got = tw.winograd_conv3x3_split_plain(tx, parts, tb).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)
    np.testing.assert_allclose(got, tw.winograd_conv3x3_plain(tx, u, tb).numpy(), atol=1e-5 * scale)


@pytest.mark.parametrize("cin,cout", [(4, 36), (20, 4), (320, 320), (3, 17)])
def test_padded_weights_fp32_layout(cin, cout):
    """The fp32 kernel's weights: U_ij transposed to [Cout, Cin_p] (K-major),
    Cin padded to a multiple of 16 with zeros, transform_weights' values
    exactly."""
    rng = np.random.default_rng(cin + cout)
    k = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    u = tw.transform_weights(k)
    ut = tw.padded_weights_fp32(u)
    cin_p = -(-cin // 16) * 16
    assert ut.shape == (16, cout, cin_p) and ut.dtype == torch.float32 and ut.is_contiguous()
    assert torch.equal(ut[:, :, :cin], u.transpose(1, 2))
    assert ut[:, :, cin:].abs().sum() == 0


def test_layout_cache_serves_no_stale_weight():
    """The public op keeps a weight's layout while the weight is unchanged,
    and makes it anew after an in-place update, for a new tensor and for a
    new tensor on recycled storage."""
    x, k, bias = (torch.from_numpy(a) for a in _case(1, (1, 8, 6, 12, 20)))
    first = tw.kernel_layout(k)
    assert tw.kernel_layout(k) is first
    want = lambda kk: tw.winograd_conv3x3_plain(x, tw.transform_weights(kk), bias)
    assert torch.equal(tw.winograd_conv3x3(x, k, bias), want(k))
    with torch.no_grad():
        k.mul_(-2.0)  # an optimizer step in place
    assert tw.kernel_layout(k) is not first
    assert torch.equal(tw.winograd_conv3x3(x, k, bias), want(k))
    k2 = k.clone()
    assert torch.equal(tw.kernel_layout(k2), tw.kernel_layout(k))
    k2.data = torch.zeros_like(k2)  # same tensor object, new storage
    assert torch.equal(tw.winograd_conv3x3(x, k2, bias), want(k2))
    key = (id(k2), k2.data_ptr(), k2.dtype, tuple(k2.shape), k2.device)
    assert key in tw._layouts
    del k2  # the entry goes with its weight
    assert key not in tw._layouts


def test_layout_of_a_non_leaf_is_not_kept():
    """A weight that is not a leaf (a cast of a parameter under autograd,
    which the backward keeps alive) gets its layout made each call and kept
    nowhere; the parameter's own layout is kept."""
    x, k, bias = (torch.from_numpy(a) for a in _case(4, (1, 6, 8, 12, 20)))
    k.requires_grad_(True)
    kd = k.double()
    assert not kd.is_leaf
    got = tw.kernel_layout(kd)
    assert not any(v[0]() is kd for v in tw._layouts.values())
    assert torch.equal(got, tw.transform_weights(kd.detach()))
    assert tw.kernel_layout(k) is tw.kernel_layout(k)
    out = tw.winograd_conv3x3(x.double(), kd, bias.double())
    out.sum().backward()
    assert k.grad is not None and not any(v[0]() is kd for v in tw._layouts.values())


def test_layout_of_an_inference_tensor_is_made_each_call():
    """A weight made under `torch.inference_mode` has no version counter:
    its layout is made anew each call and kept nowhere."""
    x, k, bias = (torch.from_numpy(a) for a in _case(2, (1, 6, 8, 12, 20)))
    with torch.inference_mode():
        ki = k * 1.0
        got = tw.winograd_conv3x3(x, ki, bias)
        assert not any(v[0]() is ki for v in tw._layouts.values())
    assert torch.equal(got, tw.winograd_conv3x3_plain(x, tw.transform_weights(k), bias))
