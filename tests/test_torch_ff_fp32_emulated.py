"""The fp32 feed-forward kernel's CUDA source (`csrc/ln_geglu_ff_fp32.cu`)
run on the CPU: compiled by the host C++ compiler against
`tests/cuda_emu.h` (one std::thread per CUDA thread, barriers, warp
shuffles) and called through its C entry with the wrapper's launch plan, and
with every GEMM2 tile width and split of F the entry takes, against
`ln_geglu_ff_plain` from numpy inputs made from a seed.

This checks what the kernel's text decides (tiles, the per-thread cp.async
ring, the transposed stages and their one barrier, ragged row blocks, the
GEGLU pairing of value and gate columns, the split's partials and their
sum, the grid's order of tiles), not the card: registers, spills and timing are
`chip_smoke.py` phase 4h's. The planted fault of 4h (`FP32_FAULTS["ff"]`,
an F chunk of GEMM2 left out) must fail here too. Tolerance: 4h's fp32
gate, 1e-5 relative L2 and 1e-5 of the largest value of out - x (fp32 sums
in another order than the CPU's matmul). The plan's work items are checked
without a compiler. The emulated part is skipped where no host C++ compiler
is installed."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_variants as kv
from adaface_tpu_torch.ops import fused_ff as tff

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "ln_geglu_ff_fp32.cu"
SMS = 132
ENTRY = "ln_geglu_ff_fp32_fwd"


# cp.async primitive -> its emulation: the kernel's own ring wait and the
# shared header's (`csrc/ffma_tile.cuh`) copy and commit
EMU_BODIES = {"cp_async16": "emu_copy(dst, src, 4, valid);", "cp_async_commit": "emu_commit();",
              "cp_async_wait_ring": "emu_wait(RING - 2);"}


def _emulated(text, names):
    """The kernel source or its header for the host compiler: the emulation
    header for the CUDA ones, the cp.async primitives `names` as emu_*
    calls, float4 accesses checked for alignment, launches as LAUNCH (the
    split's sum, which has no barrier, as LAUNCH_SEQ)."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    for name in names:
        m = re.search(r"__device__ __forceinline__ void " + name + r"\([^)]*\) \{", text)
        assert m, f"{name} not found"
        text = (text[:m.end()] + f" {EMU_BODIES[name]} }}"
                + text[text.index("\n}\n", m.end()) + 2:])
    text = text.replace("extern __shared__ float4 smem4[];", "")
    text = text.replace("reinterpret_cast<float4*>(", "emu_f4(")
    text = text.replace("reinterpret_cast<const float4*>(", "emu_cf4(")
    text = re.sub(r"(ff32_split_sum_kernel)<<<(.*?)>>>\((.*?)\);", r"LAUNCH_SEQ(\1, \2, \3);", text,
                  flags=re.S)
    text = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", r"LAUNCH(\1, \2, \3);", text,
                  flags=re.S)
    assert "<<<" not in text and "asm" not in text
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """name -> the emulated library: the source ("base") and 4h's planted
    fault ("ff"), compiled side by side against one emulated copy of the
    shared header."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("ff_fp32_emu")
    shutil.copy(os.path.join(HERE, "cuda_emu.h"), out)
    header = open(os.path.join(kv.CSRC, "ffma_tile.cuh")).read()
    (out / "ffma_tile.cuh").write_text(_emulated(
        header, ["cp_async16", "cp_async_commit"]))
    source, _, _, patches = chip_smoke.FP32_FAULTS["ff"]
    srcs = {"base": open(os.path.join(kv.CSRC, SOURCE)).read(),
            "ff": kv.patched_sources(kv.CSRC, source, patches)["kernel.cu"]}
    procs = {}
    for name, text in srcs.items():
        assert '#include "ffma_tile.cuh"' in text
        (out / f"{name}.cpp").write_text(_emulated(text, ["cp_async_wait_ring"]))
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
        fn.argtypes = tff.C_ENTRIES[ENTRY][1]
        fn.restype = ctypes.c_int
        built[name] = fn
        if name == "base":
            lib.emu_set_land.argtypes = [ctypes.c_int]
            built["land"] = lib.emu_set_land
    return built


def _case(seed, b, l, c, f):
    """x, ln scale and bias, w1 [c, 2f] and w2 [f, c] (transposed views of
    nn.Linear's weights, as the UNet passes them), b1, b2 from numpy."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))
    x = t(b, l, c)
    w1t, w2t = t(2 * f, c, scale=c ** -0.5), t(c, f, scale=f ** -0.5)
    return (x, 1 + t(c, scale=0.2), t(c, scale=0.2), w1t.t(), t(2 * f, scale=0.2), w2t.t(),
            t(c, scale=0.2))


def _run(fn, args, plan):
    """out from the emulated C entry under `plan`; the outputs, y, h and the
    split's workspace start as NaN, so an element left unwritten shows."""
    x, ln_g, ln_b, w1, b1, w2, b2 = args
    b, l, c = x.shape
    m, f = b * l, w2.shape[0]
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    nan = lambda *shape: torch.full(shape, float("nan"))
    y, h, out = nan(m, c), nan(m, f), nan(b, l, c)
    ws = nan(plan.split, m, c) if plan.split > 1 else None
    rc = fn(x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), b2.data_ptr(), y.data_ptr(), h.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(), m, c, f, 1e-5, *plan, None)
    assert rc == 0
    return out


def _errors(out, args):
    """4h's gate on the feed-forward part: (max abs error over the largest
    plain value, relative L2)."""
    return chip_smoke.fused_fp32_errors(out, tff.ln_geglu_ff_plain(*args), args[0])


def _passes(out, args):
    err, rel = _errors(out, args)
    return err <= chip_smoke.FP32_ABS_TOL and rel <= chip_smoke.FP32_REL_TOL


# (B, L, C, F, forced GEMM2 width, split; None: the plan's): ragged row
# blocks, C 64 / 192 / 320 with F = 4C and F 192 / 576 (not multiples of
# 128), every width that divides C, and splits
CASES = [(1, 130, 320, 1280, None, None), (2, 33, 64, 256, None, None),
         (1, 200, 192, 768, None, None), (2, 33, 64, 192, None, 3), (1, 129, 192, 576, 64, 2),
         (3, 50, 320, 1280, 64, 1), (1, 100, 320, 1280, 160, 2), (1, 257, 128, 512, 128, 1)]


# (case, land): every case with cp.async copies landing when waited for (a
# read before the wait sees garbage), the C64 / C192 ones and one C320 also
# landing at once (a slot refilled before its reader is done shows)
RUNS = [(c, 0) for c in CASES] + [(c, 1) for c in CASES if c[2] < 320 or c[4] == 160]


@pytest.mark.parametrize("case,land", RUNS, ids=[
    f"B{c[0]}_L{c[1]}_C{c[2]}_F{c[3]}_bn{c[4]}_s{c[5]}_"
    + ("land_at_issue" if land else "land_at_wait") for c, land in RUNS])
def test_kernel_matches_plain(libs, case, land):
    b, l, c, f, bn2, split = case
    args = _case(b * l + c + f, b, l, c, f)
    libs["land"](land)
    plan = tff.fp32_launch_plan(b * l, c, f, SMS)
    force = {k: v for k, v in (("bn2", bn2), ("split", split)) if v is not None}
    out = _run(libs["base"], args, plan._replace(**force))
    assert torch.isfinite(out).all()
    assert _passes(out, args), _errors(out, args)


@pytest.mark.parametrize("split", range(1, tff.FP32_MAX_SPLIT + 1))
def test_every_split_matches_plain(libs, split):
    """Each split the plan may choose, at 160-column tiles (odd splits) and
    64-column ones (even); a split is summed in slice order, so a repeat
    agrees bit for bit."""
    args = _case(split, 1, 70, 320, 1280)
    libs["land"](0)
    plan = tff.FP32Plan(160 if split % 2 else 64, split)
    out = _run(libs["base"], args, plan)
    assert _passes(out, args), _errors(out, args)
    if split == 3:
        assert torch.equal(out, _run(libs["base"], args, plan))


@pytest.mark.parametrize("split", [1, 3])
def test_planted_fault_fails_the_gate(libs, split):
    args = _case(9, 1, 130, 320, 1280)
    plan = tff.fp32_launch_plan(130, 320, 1280, SMS)._replace(split=split)
    libs["land"](0)
    assert not _passes(_run(libs["ff"], args, plan), args), chip_smoke.FP32_FAULTS["ff"][2]


def test_entry_refuses_plans_it_does_not_take(libs):
    args = _case(0, 1, 8, 320, 1280)
    x, ln_g, ln_b, w1, b1, w2, b2 = args
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    y, h, out = torch.empty(8, 320), torch.empty(8, 1280), torch.empty(8, 320)
    ws = torch.empty(9 * 8 * 320)
    ptrs = [t.data_ptr() for t in (x, ln_g, ln_b, w1t, b1, w2t, b2, y, h, ws, out)]
    for plan in ((128, 1), (96, 1), (160, 9), (160, 0)):
        assert libs["base"](*ptrs, 8, 320, 1280, 1e-5, *plan, None) != 0, plan
    assert libs["base"](*ptrs[:9], None, ptrs[10], 8, 320, 1280, 1e-5, 160, 2, None) != 0


# (M, C, F): the UNet's K9 shapes (B16, B8, B3 and B4 rows), ragged and edge shapes
PLAN_SHAPES = [(16 * 4096, 320, 1280), (16 * 1024, 640, 2560), (16 * 256, 1280, 5120),
               (8 * 4096, 320, 1280),
               (16 * 64, 1280, 5120), (3 * 4096, 320, 1280), (3 * 1024, 640, 2560),
               (4 * 4096, 320, 1280), (4 * 1024, 640, 2560), (1, 320, 1280), (129, 640, 2560),
               (66, 64, 192), (200, 128, 512), (3000, 1280, 5120), (9000, 192, 768)]


def _covered_once(items, m, n, k, width):
    """Every block of `tff.FP32_ROWS` rows and `width` columns of [m, n]
    (rows past m masked) has work items whose K ranges, in slice order, tile
    [0, k) in stages with no gap or overlap."""
    ranges = {}
    for it in items:
        assert it.k0 % tff.FP32_BK == 0 and it.k1 > it.k0
        ranges.setdefault((it.row0, it.col0), []).append((it.split, it.k0, it.k1))
    blocks = {(r, c) for r in range(0, m, tff.FP32_ROWS) for c in range(0, n, width)}
    if set(ranges) != blocks:
        return False
    for parts in ranges.values():
        bounds = [(k0, k1) for _, k0, k1 in sorted(parts)]
        if bounds[0][0] != 0 or bounds[-1][1] != k or any(
                a[1] != b[0] for a, b in zip(bounds, bounds[1:])):
            return False
    return True


@pytest.mark.parametrize("m,c,f", PLAN_SHAPES)
def test_plan_covers_each_output_and_f_range_once(m, c, f):
    """GEMM1's and GEMM2's tiles under the plan, and under other widths and
    splits it may take, cover every output and K range once; the plan's
    width divides C and its split leaves each slice a stage."""
    plan = tff.fp32_launch_plan(m, c, f, SMS)
    assert c % plan.bn2 == 0 and 1 <= plan.split <= min(tff.FP32_MAX_SPLIT, f // tff.FP32_BK)
    g1 = tff.fp32_gemm_tiles(m, f, c, tff.FP32_H_COLS, 1, geglu=True)
    assert _covered_once(g1, m, f, c, tff.FP32_H_COLS)
    forced = [(plan.bn2, plan.split), (64, 3), (c if c % 160 == 0 else 64, 2)]
    for bn, split in forced:
        items = tff.fp32_gemm_tiles(m, c, f, bn, split)
        assert _covered_once(items, m, c, f, bn), (bn, split)


def test_plan_fills_the_card():
    """The split is taken where the unsplit grid leaves SMs idle: B16 L64
    C1280 (8 row blocks) and B3 L1024 C640 (24) split, B16 L4096 C320 does
    not."""
    assert tff.fp32_launch_plan(16 * 64, 1280, 5120, SMS).split > 1
    assert tff.fp32_launch_plan(3 * 1024, 640, 2560, SMS).split > 1
    assert tff.fp32_launch_plan(16 * 4096, 320, 1280, SMS).split == 1
