"""The fp32 flash kernels' CUDA source (`csrc/flash_attn_fp32.cu`) run on the
CPU: compiled by the host C++ compiler against `tests/cuda_emu.h` (one
std::thread per CUDA thread, barriers, warp shuffles, cp.async copies that
land when waited for or at once) and called through its C entries with the
wrapper's launch plans, against the plain versions from numpy inputs made
from a seed.

This checks what the kernel's text decides (tiling, ring order and waits,
ragged and unaligned edges, the plan's CTA shapes, the roundings' order),
not the card: registers, spills, timing and the hardware's own cp.async
are `chip_smoke.py` phase 4g's. The planted faults of 4g must fail here too.
Skipped where no host C++ compiler is installed."""

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
from adaface_tpu_torch.ops import flash_attention as tfa

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "flash_attn_fp32.cu"
SMS = 132
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _emulated(text):
    """The kernel source for the host compiler: the emulation header for the
    CUDA ones, the cp.async primitives as emu_* calls, launches as LAUNCH
    (LAUNCH_SEQ)."""
    text = text.replace("#include <cuda_bf16.h>", '#include "cuda_emu.h"')
    text = text.replace("#include <cuda_runtime.h>", "")

    def body(name, new, template=""):
        nonlocal text
        m = re.search(template + r"__device__ __forceinline__ void " + name + r"\([^)]*\) \{",
                      text)
        assert m, f"{name} not found in {SOURCE}"
        i, depth = m.end(), 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        text = text[:m.end()] + new + "}" + text[i:]

    body("cp_async16", " emu_copy(dst, src, 4, valid); ")
    body("cp_async4", " emu_copy(dst, src, 1, valid); ")
    body("cp_async_commit", " emu_commit(); ")
    body("cp_async_wait_all", " emu_wait(0); ")
    body("cp_async_wait_ring", " emu_wait(STAGES - 2); ")
    body("cp_async_wait_n", " emu_wait(N); ", r"template <int N>\n")
    text = text.replace("extern __shared__ float4 smem4[];", "")
    # float4 accesses checked for 16-byte alignment
    text = text.replace("reinterpret_cast<float4*>(", "emu_f4(")
    text = text.replace("reinterpret_cast<const float4*>(", "emu_cf4(")
    # launches; the split's sum (no barrier) runs its threads one by one
    text = re.sub(r"(flash_fp32_bwd_sum_kernel)<<<(.*?)>>>\((.*?)\);", r"LAUNCH_SEQ(\1, \2, \3);",
                  text, flags=re.S)
    text = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", r"LAUNCH(\1, \2, \3);", text,
                  flags=re.S)
    assert "asm" not in text.replace("emu_", ""), "inline asm left in the emulated source"
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """name -> the emulated library: the source ("base") and 4g's planted
    faults of the backward, compiled side by side."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("fp32_emu")
    shutil.copy(os.path.join(HERE, "cuda_emu.h"), out)
    srcs = {"base": open(os.path.join(kv.CSRC, SOURCE)).read()}
    for key in ("flash_dq", "flash_dkv"):
        source, _, _, patches = chip_smoke.FP32_FAULTS[key]
        srcs[key] = kv.patched_sources(kv.CSRC, source, patches)["kernel.cu"]
    procs = {}
    for name, text in srcs.items():
        (out / f"{name}.cpp").write_text(_emulated(text))
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
             "-Wno-unknown-pragmas", "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"{name} did not compile:\n{log[-4000:]}"
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for entry in ("flash_attn_fp32_fwd", "flash_attn_fp32_bwd_dq",
                      "flash_attn_fp32_bwd_dkv"):
            fn = getattr(lib, entry)
            fn.argtypes = tfa.C_ENTRIES[entry][1]
            fn.restype = ctypes.c_int
        lib.emu_set_land.argtypes = [_I]
        built[name] = lib
    return built


def _case(seed, b, lq, lk, h, d, with_bias, offset):
    """q, k, v, dO (rows `offset` floats off a 16-byte boundary where
    offset > 0) and the key bias (30% masked, batch row 0 fully masked when
    B > 1), from numpy."""
    rng = np.random.default_rng(seed)

    def rand(l):
        base = torch.from_numpy(rng.standard_normal((b, l, h * d + offset)).astype(np.float32))
        return base[:, :, offset:]

    q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
    bias = None
    if with_bias:
        bias = torch.from_numpy(np.where(rng.random((b, lk)) > 0.3, 0.0, -1e30)
                                .astype(np.float32))
        if b > 1:
            bias[0] = -1e30
    return q, k, v, do, bias


def _backward(lib, q, k, v, do, bias, lse, delta, h, warps=None, split=None):
    """dq, dk, dv, dbias from the emulated C entries with the wrapper's plan
    (or `warps` a CTA, `split` slices); outputs and the split's workspace
    start as NaN, so an element left unwritten shows."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // h
    plan = tfa.bwd_fp32_launch_plan(b, h, lq, lk, d, SMS)
    plan = [chip_smoke.forced_fp32_bwd(tfa, kind, d, launch, warps, split)
            for kind, launch in (("dq", plan.dq), ("dkv", plan.dkv))]
    ws = torch.full((tfa.BWD_FP32_MAX_SPLIT * (b * max(lq, lk) * inner * 2 + b * h * lk + 4),),
                    float("nan"))
    dq = torch.full((b, lq, inner), float("nan"))
    dk, dv = torch.full((b, lk, inner), float("nan")), torch.full((b, lk, inner), float("nan"))
    dbias = torch.full((b, h, lk), float("nan"))
    sc = d ** -0.5
    bp = None if bias is None else bias.data_ptr()
    st = tfa._strides(q, k, v, do, dq)
    rc = lib.flash_attn_fp32_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), bp, dq.data_ptr(), b, h,
                                    lq, lk, d, *plan[0], ctypes.addressof(st),
                                    sc * tfa.LOG2E, sc, ws.data_ptr(), None)
    assert rc == 0
    st = tfa._strides(q, k, v, do, dk, dv)
    rc = lib.flash_attn_fp32_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(), bp, dk.data_ptr(),
                                     dv.data_ptr(), dbias.data_ptr(), b, h, lq, lk, d,
                                     *plan[1], ctypes.addressof(st), sc * tfa.LOG2E, sc,
                                     ws.data_ptr(), None)
    assert rc == 0
    return dq, dk, dv, dbias


def _errors(got, ref):
    """(relative L2, max abs over the largest plain value): chip_smoke's
    fp32 gate, FP32_REL_TOL and FP32_ABS_TOL."""
    diff = (got.double() - ref.double())
    return ((diff.norm() / ref.double().norm()).item(),
            (diff.abs().max() / ref.abs().max()).item())


def _passes(got, ref):
    rel, err = _errors(got, ref)
    return rel <= chip_smoke.FP32_REL_TOL and err <= chip_smoke.FP32_ABS_TOL


# (B, Lq, Lk, H, d, key bias, row offset, warps a CTA and split, or None
# for the plan's)
BWD_CASES = [(1, 70, 130, 2, 40, True, 0, 1, 2), (2, 64, 64, 1, 80, True, 0, 2, 1),
             (1, 33, 20, 2, 160, True, 0, None, None), (2, 100, 77, 1, 40, True, 1, 4, 2),
             (1, 130, 200, 1, 80, False, 1, None, 3), (1, 40, 150, 1, 160, False, 0, 2, None),
             (2, 129, 65, 1, 40, False, 0, None, 2), (1, 200, 333, 1, 160, True, 1, 4, 4)]


@pytest.mark.parametrize("land", [0, 1], ids=["land_at_wait", "land_at_issue"])
@pytest.mark.parametrize("case", BWD_CASES, ids=[f"B{c[0]}_Lq{c[1]}_Lk{c[2]}_H{c[3]}_d{c[4]}"
                                                 f"{'_bias' if c[5] else ''}"
                                                 f"{'_unaligned' if c[6] else ''}_w{c[7]}_s{c[8]}"
                                                 for c in BWD_CASES])
def test_backward_matches_plain(libs, case, land):
    """Forced splits above the tiles of one side are capped there."""
    b, lq, lk, h, d, with_bias, offset, warps, split = case
    if split is not None:
        split = min(split, -(-min(lq, lk) // 64))
    q, k, v, do, bias = _case(lq * lk + d, b, lq, lk, h, d, with_bias, offset)
    o = tfa.flash_attention_blc_plain(q, k, v, h, bias)
    lse = tfa.row_lse_plain(q, k, h, bias).contiguous()
    delta = tfa.row_delta(o, do, h)
    libs["base"].emu_set_land(land)
    got = _backward(libs["base"], q, k, v, do, bias, lse, delta, h, warps, split)
    plain = tfa.flash_backward_plain(q, k, v, bias, o, do, lse, h)
    for what, g, ref in zip(("dq", "dk", "dv", "dbias"), got, plain):
        if what == "dbias" and bias is None:
            continue
        assert torch.isfinite(g).all(), what
        assert _passes(g, ref), (what, _errors(g, ref))


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("key,what", [("flash_dq", 0), ("flash_dkv", 1)])
def test_planted_backward_faults_fail_the_gate(libs, key, what, split):
    q, k, v, do, bias = _case(7, 2, 100, 150, 2, 40, True, 0)
    o = tfa.flash_attention_blc_plain(q, k, v, 2, bias)
    lse = tfa.row_lse_plain(q, k, 2, bias).contiguous()
    delta = tfa.row_delta(o, do, 2)
    libs[key].emu_set_land(0)
    got = _backward(libs[key], q, k, v, do, bias, lse, delta, 2, split=split)
    plain = tfa.flash_backward_plain(q, k, v, bias, o, do, lse, 2)
    assert not _passes(got[what], plain[what]), chip_smoke.FP32_FAULTS[key][2]


# (B, Lq, Lk, H, d, key bias): the forward's plan with and without its key
# split (L256 d160 at B3 splits on 132 SMs)
FWD_CASES = [(2, 130, 77, 2, 40, True), (1, 96, 150, 2, 80, False), (3, 64, 100, 1, 160, True)]


@pytest.mark.parametrize("case", FWD_CASES, ids=[f"B{c[0]}_Lq{c[1]}_Lk{c[2]}_d{c[4]}"
                                                 for c in FWD_CASES])
@pytest.mark.parametrize("key_split", [1, 2])
def test_forward_matches_plain(libs, case, key_split):
    b, lq, lk, h, d, with_bias = case
    q, k, v, _, bias = _case(lq + lk + d, b, lq, lk, h, d, with_bias, 0)
    plan = tfa.fwd_fp32_launch_plan(b, h, lq, lk, d, SMS, key_split=key_split)
    o = torch.full((b, lq, h * d), float("nan"))
    lse = torch.full((b, h, lq), float("nan"))
    st = tfa._strides(q, k, v, o)
    libs["base"].emu_set_land(0)
    rc = libs["base"].flash_attn_fp32_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, 0, plan.rows, plan.threads,
        ctypes.addressof(st), d ** -0.5 * tfa.LOG2E, None)
    assert rc == 0
    assert _passes(o, tfa.flash_attention_blc_plain(q, k, v, h, bias))
    ref_lse = tfa.row_lse_plain(q, k, h, bias)
    assert (lse - ref_lse).abs().max().item() <= chip_smoke.FP32_ABS_TOL
