#!/usr/bin/env python3
"""Time variants of the flash-attention kernels side by side on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 flash_variants.py                    # every forward variant
    python3 flash_variants.py base fakeex2       # some of them
    python3 flash_variants.py --bwd              # every backward variant
    python3 flash_variants.py --bwd old base     # the backward against an older tree's

Each variant is the kernel source (`adaface_tpu_torch/csrc/flash_attn_packed.cu`,
or with `--bwd` `flash_attn_bwd.cu`) with a few exact text substitutions
(listed in FWD_VARIANTS / BWD_VARIANTS; a substitution applies to the source
or to the shared header that holds its text), built by nvcc into
`_variants/<name>/` (git-ignored) beside copies of the headers, and called
through the same C interface as the port's wrapper. The backward variant
`old` is the tree unpacked under `_checkout/` (`git archive <commit> | tar -x
-C _checkout`), called through its interface from before the dk/dv split.

Forward: at the generate self-attention shapes, for two interleaved rounds of
all variants (base, ..., base, ...), each one's time (CUDA events, median of
back-to-back launches), its CUDA return code and its relative L2 error against
the plain fp32 version. Backward: at the training shapes with the key bias
and the cross-attention's 128 keys, each variant's dq and dk/dv times and
relative L2 errors (dq, dk, dv) against the plain backward, and the SDPA
backward's time. Every line carries the card's name and power limit.
Variants that change the function (fakeex2) exist to measure a cost, and
their error is expected.
"""

import ctypes
import sys

import chip_smoke as cs
import kernel_variants as kv

SHAPES = [(16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160)]
NWG = "  static constexpr int NWG = D <= 80 && FLAGS == 0 && !BIAS ? 4 : 2;"
Q_REGS = "  static constexpr bool Q_REGS = D <= 40 && FLAGS == 0 && !BIAS;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
FWD_VARIANTS = {
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
# (B, Lq, Lk, H, d, key bias): the recon micro-step's self-attentions (one
# also without the bias) and its cross-attention under CROSS=1
BWD_SHAPES = [(3, 4096, 4096, 8, 40, True), (3, 4096, 4096, 8, 40, False),
              (3, 1024, 1024, 8, 80, True), (3, 256, 256, 8, 160, True),
              (3, 4096, 128, 8, 40, True), (3, 1024, 128, 8, 80, True)]
BWD_A_REGS = "  static constexpr bool DQ_A_REGS = D > 40 && D <= 80;"
BWD_STAGES = "  static constexpr int STAGES = D > 80 ? 3 : 4;"
BWD_VARIANTS = {
    "old": None,  # the backward of the tree in _checkout/
    "base": [],
    # exp2 replaced by a move (wrong output): what the special-function unit costs
    "fakeex2": [(EX2, "y = x;")],
    # dq's resident operand of the score products from shared memory at d80
    "smem_a": [(BWD_A_REGS, "  static constexpr bool DQ_A_REGS = false;")],
    # dq with two warpgroups a CTA at d40 too, its Q/dO fragments in registers
    "dq2wg": [("  static constexpr int DQ_NWG = D <= 40 ? 4 : NWG;",
               "  static constexpr int DQ_NWG = NWG;"),
              (BWD_A_REGS, "  static constexpr bool DQ_A_REGS = D <= 80;")],
    # the elementwise work left out (wrong output): what the products, the
    # copies and the barriers take alone
    "noelem": [("        s[i] = p * (dp[i] - dl[r]);", "        s[i] = dp[i];"),
               ("        st[e] = p;\n", "        st[e] = dpt[e];\n"),
               ("        dpt[e] = valid ? p * (dpt[e] - dlt) : 0.0f;\n", "")],
    # a shallower ring
    "stages3": [(BWD_STAGES, "  static constexpr int STAGES = 3;")],
}


def variant_specs(names, source, variants):
    """name -> (source directory, source, patches) for `kernel_variants`;
    a variant of None is the source of the tree in `_checkout/`."""
    return {name: (kv.OLD_CSRC, source, []) if variants[name] is None
            else (kv.CSRC, source, variants[name]) for name in names}


def build(names, source, variants):
    """Build the variants side by side; returns name -> library."""
    libs = {}
    for name, (lib, log) in kv.build(variant_specs(names, source, variants)).items():
        spills = [line for line in kv.ptxas_lines(log) if "spill" in line]
        if spills:
            cs.say(f"[variants] {name} spills: {spills}")
        libs[name] = lib
    return libs


def run_forward(torch, fa, names, card):
    libs = build(names, "flash_attn_packed.cu", FWD_VARIANTS)
    fns = {}
    for name, lib in libs.items():
        fn = lib.flash_attn_packed_fwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 6 + [i] * 6 + [p, f, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
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


def run_backward(torch, fa, names, card):
    import torch.nn.functional as F

    libs = build(names, "flash_attn_bwd.cu", BWD_VARIANTS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.flash_attn_bwd_dq.argtypes = [p] * 8 + [i] * 5 + [p, f, f, p]
        lib.flash_attn_bwd_dq.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, lq, lk, h, d, with_bias in BWD_SHAPES:
        rand = lambda l: torch.randn((b, l, h * d), generator=gen, device="cuda").bfloat16()
        q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
        bias = torch.where(torch.rand((b, lk), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
        if not with_bias:
            bias = torch.zeros_like(bias)  # timed without it, below
        out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
        delta = fa.row_delta(out, do, h)
        pdq, pdk, pdv, _ = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        split = fa.bwd_launch_plan(b, h, lq, lk, d, sms).split
        ws = torch.empty(split * b * h * lk * (2 * d + 1), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        sc = d ** -0.5
        st_dq, st_dkv = fa._strides(q, k, v, do, dq), fa._strides(q, k, v, do, dk, dv)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), bias.data_ptr() if with_bias else None)
        res = []
        for _ in range(2):
            for name, lib in libs.items():
                dkv_fn = lib.flash_attn_bwd_dkv
                old = BWD_VARIANTS[name] is None
                dkv_fn.argtypes = [p] * 10 + [i] * 5 + [p, f, f] + ([p] if old else [i, p, p])
                dkv_fn.restype = ctypes.c_int
                tail = (stream,) if old else (split, ws.data_ptr(), stream)
                call_dq = lambda lib=lib: lib.flash_attn_bwd_dq(
                    *ptrs, dq.data_ptr(), b, h, lq, lk, d, ctypes.addressof(st_dq),
                    sc * fa.LOG2E, sc, stream)
                call_dkv = lambda fn=dkv_fn, tail=tail: fn(  # no dbias, as in training
                    *ptrs, dk.data_ptr(), dv.data_ptr(), None, b, h, lq, lk, d,
                    ctypes.addressof(st_dkv), sc * fa.LOG2E, sc, *tail)
                rc = (call_dq(), call_dkv())
                torch.cuda.synchronize()
                rels = [cs.kernel_errors(got, ref)[1]
                        for got, ref in ((dq, pdq), (dk, pdk), (dv, pdv))]
                res.append(f"{name} dq {cs.time_ms(torch, call_dq):.4f} dk/dv "
                           f"{cs.time_ms(torch, call_dkv):.4f} ms (rc {rc}, rel L2 "
                           + "/".join(f"{r:.2e}" for r in rels) + ")")
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.bfloat16()[:, None, None, :], scale=sc)
        sdpa_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh), do.unflatten(-1, (h, d)).transpose(1, 2), retain_graph=True))
        cs.say(f"[variants] bwd B{b} Lq{lq} Lk{lk} H{h} d{d} {'bias' if with_bias else 'no bias'}"
               f" split {split}: " + "; ".join(res)
               + f"; sdpa backward {sdpa_ms:.4f} ms [{card}]")
        del q, k, v, do, out, lse, delta, pdq, pdk, pdv, dq, dk, dv, ws, o_lib


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import flash_attention as fa

    args = sys.argv[1:]
    bwd = "--bwd" in args
    args = [a for a in args if a != "--bwd"]
    variants = BWD_VARIANTS if bwd else FWD_VARIANTS
    names = args or list(variants)
    for name in names:
        if name not in variants:
            cs.fail(f"unknown variant {name}; known: {list(variants)}")
    card, _ = cs.phase_card(torch)
    (run_backward if bwd else run_forward)(torch, fa, names, card)


if __name__ == "__main__":
    main()
