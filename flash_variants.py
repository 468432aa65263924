#!/usr/bin/env python3
"""Time variants of the flash-attention forward kernel side by side on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 flash_variants.py                 # every variant
    python3 flash_variants.py base fakeex2    # some of them

Each variant is `adaface_tpu_torch/csrc/flash_attn_packed.cu` with a few
exact text substitutions (listed in VARIANTS), built by nvcc into
`_variants/<name>/` (git-ignored) beside copies of the shared headers, and
called through the same C interface as the port's wrapper. At the generate
self-attention shapes it prints, for two interleaved rounds of all variants
(base, ..., base, ...), each one's time (CUDA events, median of back-to-back
launches), its CUDA return code and its relative L2 error against the plain
fp32 version, with the card's name and power limit. Variants that change the
function (fakeex2) exist to measure a cost, and their error is expected.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import chip_smoke as cs
from adaface_tpu_torch import kernels

CSRC = "adaface_tpu_torch/csrc"
OUT = "_variants"
SHAPES = [(16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160)]
NWG = "  static constexpr int NWG = D <= 80 && FLAGS == 0 && !BIAS ? 4 : 2;"
Q_REGS = "  static constexpr bool Q_REGS = D <= 40 && FLAGS == 0 && !BIAS;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
VARIANTS = {
    "base": [],
    # two warpgroups (BQ 128) a CTA everywhere: twice the K/V bytes per query row
    "nwg2": [(NWG, "  static constexpr int NWG = 2;")],
    # Q K^T with Q from shared memory at d40 too
    "qsmem": [(Q_REGS, "  static constexpr bool Q_REGS = false;")],
    # exp2 replaced by a move: what the special-function unit costs (wrong output)
    "fakeex2": [(EX2, "y = x;")],
    # the ragged-edge key mask on every tile, not only on the last
    "masked": [("        kt * BK + BK <= Lk\n", "        false\n")],
}


def build(names):
    """Start one nvcc per variant, wait for all; returns name -> C entry."""
    procs = {}
    source = open(f"{CSRC}/flash_attn_packed.cu").read()
    for name in names:
        d = f"{OUT}/{name}"
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(CSRC):
            if h.endswith(".cuh"):
                shutil.copy(f"{CSRC}/{h}", d)
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                cs.fail(f"variant {name}: its patch does not apply ({old!r})")
            text = text.replace(old, new)
        open(f"{d}/kernel.cu", "w").write(text)
        procs[name] = subprocess.Popen(
            [kernels.cuda_tool("nvcc"), *kernels.NVCC_FLAGS, "-o", f"{d}/lib.so",
             f"{d}/kernel.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"variant {name}: nvcc exited {proc.returncode}\n{log[-3000:]}")
        fn = ctypes.CDLL(os.path.abspath(f"{OUT}/{name}/lib.so")).flash_attn_packed_fwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 6 + [i] * 6 + [p, f, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import flash_attention as fa

    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            cs.fail(f"unknown variant {name}; known: {list(VARIANTS)}")
    card, _ = cs.phase_card(torch)
    fns = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, l, h, d in SHAPES:
        q, k, v = (torch.randn((b, l, h * d), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        plain = fa.flash_attention_blc_plain(q, k, v, h)
        out = torch.empty_like(q)
        st = fa._strides(q, k, v, out)
        stream = torch.cuda.current_stream().cuda_stream
        sc = d ** -0.5 * fa.LOG2E
        res = []
        for _ in range(2):
            for name, fn in fns.items():
                def call(fn=fn):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
                              None, b, h, l, l, d, 0, ctypes.addressof(st), sc, stream)
                err = call()
                torch.cuda.synchronize()
                _, rel = cs.kernel_errors(out, plain)
                res.append(f"{name} {cs.time_ms(torch, call):.4f} ms (rc {err}, rel L2 {rel:.2e})")
        cs.say(f"[variants] B{b} L{l} H{h} d{d}: " + "; ".join(res) + f" [{card}]")


if __name__ == "__main__":
    main()
