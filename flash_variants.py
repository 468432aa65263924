#!/usr/bin/env python3
"""Time variants of the flash-attention kernels side by side on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 flash_variants.py                    # every forward variant
    python3 flash_variants.py base fakeex2       # some of them
    python3 flash_variants.py --bwd              # every backward variant
    python3 flash_variants.py --bwd old base     # the backward against an older tree's
    python3 flash_variants.py --fp32             # every variant of the fp32 forward
    python3 flash_variants.py --fp32 old base    # the fp32 forward against an older tree's
    python3 flash_variants.py --fp32-bwd old base  # the fp32 backward against an older tree's
    python3 flash_variants.py --fp32-bwd-model   # the fp32 backward plan's estimates (no card)

Each variant is the kernel source (`adaface_tpu_torch/csrc/flash_attn_packed.cu`,
with `--bwd` `flash_attn_bwd.cu`, with `--fp32` and `--fp32-bwd`
`flash_attn_fp32.cu`) with a few exact text substitutions (listed in
FWD_VARIANTS / BWD_VARIANTS / FP32_VARIANTS / FP32_BWD_VARIANTS; a
substitution applies to the source or to the shared header
that holds its text), built by nvcc into
`_variants/<name>/` (git-ignored) beside copies of the headers, and called
through the same C interface as the port's wrapper. The backward variant
`old` is the tree unpacked under `_checkout/` (`git archive <commit> | tar -x
-C _checkout`), called through its interface from before the dk/dv split;
the fp32 variant `old` likewise, through its interface from before the
fp32 forward took a launch plan (with `--fp32-bwd`, before the fp32
backward took one).

Forward: at the generate self-attention shapes, for two interleaved rounds of
all variants (base, ..., base, ...), each one's time (CUDA events, median of
back-to-back launches), its CUDA return code and its relative L2 error against
the plain fp32 version. Backward: at the training shapes with the key bias
and the cross-attention's 128 keys, each variant's dq and dk/dv times and
relative L2 errors (dq, dk, dv) against the plain backward, and the SDPA
backward's time. fp32 (`--fp32`): the fp32 forward with its lse at the
training shapes (B3 with the key bias and a fully masked batch row, B4
without, as the micro-steps run them) and the generate shapes, each
variant's time, return code and relative L2 error against the plain fp32
version, beside SDPA fp32 (TF32 off) and the FFMA bound; a variant may
force the plan's key split or warps a CTA (`ks1`, `ks2`, `w2`, `w4`). fp32
backward (`--fp32-bwd`): dq and dk/dv through their C entries at the six
training shapes (B3 with the key bias and a fully masked batch row, B4
without), each variant's times, return codes and relative L2 errors (dq,
dk, dv) against the plain backward, in two interleaved rounds, beside
SDPA's fp32 backward (TF32 off) and the FFMA bounds; a variant may force the
plan's warps a CTA (`w1`, `w2`, `w4`, with the plan's split) or split (`s1`,
`s2`, `s4`, with the plan's warps). Every line carries the card's name and
power limit. `--fp32-bwd-model` needs no card: at the same six shapes on
132 SMs it prints the estimate (ms) of `bwd_fp32_launch_plan`'s time model
for each kernel, warps a CTA and split, and the plan's choice.
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

# (B, L, H, d, key bias) of the fp32 forward: the recon (B3, bias) and
# compos (B4) micro-steps' self-attentions, then the fp32 request's
FP32_SHAPES = [(3, 4096, 8, 40, True), (4, 4096, 8, 40, False), (3, 1024, 8, 80, True),
               (4, 1024, 8, 80, False), (3, 256, 8, 160, True), (4, 256, 8, 160, False),
               (16, 4096, 8, 40, False), (8, 4096, 8, 40, False), (16, 1024, 8, 80, False),
               (16, 256, 8, 160, False)]
FP32_STAGES = "constexpr int STAGES = 3;"
FP32_TM = "  static constexpr int TM = D > 80 ? 4 : 8;  // rows a lane"
FP32_VARIANTS = {
    "old": None,  # the fp32 forward of the tree in _checkout/
    "base": [],
    # the ring two or four stages deep
    "stages2": [(FP32_STAGES, FP32_STAGES.replace("3;", "2;"))],
    "stages4": [(FP32_STAGES, FP32_STAGES.replace("3;", "4;"))],
    # 4 rows a lane (16 a warp) at every head dim: fewer registers, more
    # shared-memory reads per FFMA
    "tm4": [(FP32_TM, "  static constexpr int TM = 4;  // rows a lane")],
    # exp2 replaced by a subtraction (wrong output): what exp2 costs
    "fakeex2": [("        float p = exp2f((EXPBF16 ? bf16_round(s[j]) : s[j]) - m_use);",
                 "        float p = s[j] - m_use;")],
    # stages of 40 head columns at d160 under the key split too: twice the
    # stages and barriers a tile, half the ring's bytes
    "cw40": [("  static constexpr int CW = D == 160 && KS == 2 ? 80 : 40;",
              "  static constexpr int CW = 40;")],
    # stages of 80 head columns at d80 and d160 (KS 1 too)
    "cw80": [("  static constexpr int CW = D == 160 && KS == 2 ? 80 : 40;",
              "  static constexpr int CW = D == 40 ? 40 : 80;")],
    # the chunk products' loops not unrolled: a smaller kernel (instruction
    # cache) for more loop overhead
    "unroll1": [("#pragma unroll 2\n  for (int k4 = 0;", "#pragma unroll 1\n  for (int k4 = 0;"),
                ("#pragma unroll 2\n  for (int j4 = 0;", "#pragma unroll 1\n  for (int j4 = 0;")],
    # the p V product left out (wrong output): what the score product, the
    # softmax and the copies take alone
    "nopv": [("      pv_chunk<TM, KW, C::NF4, C::NR, LDC>(o[c], pr, vt + kh * KW * LDC, cg);",
              "      (void)vt;")],
    # the plan's key split or warps a CTA forced (base source)
    "ks1": [], "ks2": [], "w2": [], "w4": [],
}
# variant -> warp rows (for a TM patch)
FP32_WARP_ROWS = {"tm4": {40: 16, 80: 16, 160: 16}}
# variant -> the plan's key split or warps a CTA forced
FP32_PLANS = {"ks1": {"key_split": 1}, "ks2": {"key_split": 2}, "w2": {"warps": 2},
              "w4": {"warps": 4}}


# (B, L, H, d, key bias) of the fp32 backward: the recon (B3, bias) and
# compos (B4) micro-steps' self-attentions
FP32_BWD_SHAPES = [(3, 4096, 8, 40, True), (3, 1024, 8, 80, True), (3, 256, 8, 160, True),
                   (4, 4096, 8, 40, False), (4, 1024, 8, 80, False), (4, 256, 8, 160, False)]
BWD_TR = "  static constexpr int TR = DKV ? (D == 40 ? 8 : D == 80 ? 4 : 2) : (D > 40 ? 4 : 8);"
FP32_BWD_VARIANTS = {
    "old": None,  # the fp32 backward of the tree in _checkout/
    "base": [],
    # the ring three stages deep
    "stages3": [("constexpr int BWD_STAGES = 2;", "constexpr int BWD_STAGES = 3;")],
    # dq with 8 rows a lane at d80 (32 a warp): more FFMA a read, 4 warps an SM
    "dq80tm8": [(BWD_TR, BWD_TR.replace("(D > 40 ? 4 : 8)", "(D > 80 ? 4 : 8)"))],
    # the second products (ds K; p^T dO, ds^T Q) left out (wrong output):
    # what the score products, the elementwise work and the copies take alone
    "nosecond": [("      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(g[c], pr, kt, cg);",
                  "      (void)kt;"),
                 ("      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(gv[c], pr, dt, cg);", ""),
                 ("      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(gk[c], pr, qt, cg);",
                  "      (void)qt;")],
    # exp2 replaced by a subtraction (wrong output): what exp2 costs
    "fakeex2": [("        float p = exp2f(x - lr[4 * i]);", "        float p = x - lr[4 * i];"),
                ("        float p = exp2f(x - lq[j]);", "        float p = x - lq[j];")],
    # the plan's warps a CTA or split forced (base source)
    "w1": [], "w2": [], "w4": [], "s1": [], "s2": [], "s4": [],
}
# variant -> warp rows by kernel and head dim, where a TR patch changes them
FP32_BWD_WARP_ROWS = {"dq80tm8": {"dq": {80: 32}}}
FP32_BWD_PLANS = {"w1": {"warps": 1}, "w2": {"warps": 2}, "w4": {"warps": 4},
                  "s1": {"split": 1}, "s2": {"split": 2}, "s4": {"split": 4}}


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


def fp32_plan(fa, name, b, l, h, d, sms):
    """(rows, threads) a CTA of variant `name` at one shape, or None where a
    forced plan does not exist: the plan, with the variant's warp rows, key
    split or warps a CTA where it says so."""
    force = FP32_PLANS.get(name, {})
    plan = fa.fwd_fp32_launch_plan(b, h, l, l, d, sms, key_split=force.get("key_split"))
    wr = FP32_WARP_ROWS.get(name, fa.FWD_FP32_WARP_ROWS)[d]
    warps = force.get("warps", plan.threads // 32)
    if warps % plan.key_split:
        return None
    return warps // plan.key_split * wr, 32 * warps


def clock_under_load(torch, call, launches=60):
    """The SM clock and power draw nvidia-smi reads while `launches`
    back-to-back calls of `call` (queued, not yet run) keep the card busy:
    an FFMA kernel at full occupancy may hold the card at its power limit
    below its top clock, which a short profiled run does not show."""
    import subprocess

    for _ in range(launches):
        call()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return f"under load {smi.stdout.strip()}"


def run_fp32(torch, fa, names, card, exp2_rate):
    import torch.nn.functional as F

    srcs = {n: FP32_VARIANTS[n] for n in names if n not in FP32_PLANS}
    if any(n in FP32_PLANS for n in names):
        srcs.setdefault("base", [])
    libs = build(list(srcs), "flash_attn_fp32.cu", FP32_VARIANTS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, lib in libs.items():
        old = FP32_VARIANTS[name] is None
        lib.flash_attn_fp32_fwd.argtypes = [p] * 6 + [i] * (6 if old else 8) + [p, f, p]
        lib.flash_attn_fp32_fwd.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(15)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, l, h, d, with_bias in FP32_SHAPES:
        q, k, v = (torch.randn((b, l, h * d), generator=gen, device="cuda") for _ in range(3))
        bias = None
        if with_bias:
            bias = torch.where(torch.rand((b, l), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
            bias[0] = -1e30  # a fully masked batch row
        plain = fa.flash_attention_blc_plain(q, k, v, h, bias)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, l), device="cuda")
        st = fa._strides(q, k, v, out)
        stream = torch.cuda.current_stream().cuda_stream
        sc = d ** -0.5 * fa.LOG2E
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, h, l, l, d, 0)
        res, calls = [], {}
        for _ in range(2):
            for name in names:
                fn = libs["base" if name in FP32_PLANS else name].flash_attn_fp32_fwd
                plan = () if FP32_VARIANTS[name] is None else fp32_plan(fa, name, b, l, h, d, sms)
                if plan is None:
                    continue
                call = lambda fn=fn, plan=plan: fn(*head, *plan, ctypes.addressof(st), sc, stream)
                calls[name] = call
                out.zero_()
                err = call()
                torch.cuda.synchronize()
                _, rel = cs.kernel_errors(out, plain)
                rows = f" rows {plan[0]} threads {plan[1]}" if plan else ""
                res.append(f"{name}{rows} {cs.time_ms(torch, call):.4f} ms "
                           f"(rc {err}, rel L2 {rel:.2e})")
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias[:, None, None, :]
        sdpa_ms = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=d ** -0.5))
        fb = cs.fp32_bound(b, l, l, h, d, exp2_rate, "fwd", with_bias)
        load = clock_under_load(torch, calls.get("base") or next(iter(calls.values())))
        cs.say(f"[variants] fp32 fwd+lse B{b} L{l} H{h} d{d} {'bias' if with_bias else 'no bias'}: "
               + "; ".join(res) + f"; sdpa fp32 {sdpa_ms:.4f} ms; bound {fb[0]:.4f} ms ({fb[1]}); "
               f"{load} [{card}]")
        del q, k, v, out, lse, plain, qh, kh, vh


def fp32_bwd_plan(fa, name, b, l, h, d, sms):
    """((dq rows, threads, split), (dk/dv keys, threads, split)) of variant
    `name` at one shape: the plan, with the variant's warp rows, or its
    forced warps a CTA or split (capped at the tiles)."""
    force = dict(FP32_BWD_PLANS.get(name, {}))
    if "split" in force:
        force["split"] = min(force["split"], -(-l // 64))
    plan = fa.bwd_fp32_launch_plan(b, h, l, l, d, sms)
    out = []
    for kind, launch in (("dq", plan.dq), ("dkv", plan.dkv)):
        wr = FP32_BWD_WARP_ROWS.get(name, {}).get(kind, {}).get(d)
        rows, threads, split = cs.forced_fp32_bwd(fa, kind, d, launch, **force)
        out.append((threads // 32 * wr if wr else rows, threads, split))
    return out


def fp32_bwd_model(fa, sms=132):
    """The fp32 backward plan's time model at the six training shapes: for
    each kernel and warps a CTA, its estimate at splits 1..4 and the plan's
    choice (printed; needs no card)."""
    for b, l, h, d, _ in FP32_BWD_SHAPES:
        plan = fa.bwd_fp32_launch_plan(b, h, l, l, d, sms)
        for kind, launch in (("dq", plan.dq), ("dkv", plan.dkv)):
            for w in fa.BWD_FP32_WARPS:
                est = [fa._bwd_fp32_seconds(kind, b, h, l, l, d, sms, w, sp) * 1e3
                       for sp in range(1, min(fa.BWD_FP32_MAX_SPLIT, -(-l // 64)) + 1)]
                cs.say(f"[model] fp32 bwd B{b} L{l} H{h} d{d} {kind} {w} warps: splits 1.."
                       f"{len(est)} " + " ".join(f"{e:.4f}" for e in est) + " ms"
                       + (f"  <- plan (split {launch.split})"
                          if launch.threads == 32 * w else "") + f" [{sms} SMs]")


def run_fp32_bwd(torch, fa, names, card, exp2_rate):
    import torch.nn.functional as F

    srcs = {n: FP32_BWD_VARIANTS[n] for n in names if n not in FP32_BWD_PLANS}
    if any(n in FP32_BWD_PLANS for n in names):
        srcs.setdefault("base", [])
    libs = build(list(srcs), "flash_attn_fp32.cu", FP32_BWD_VARIANTS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, lib in libs.items():
        old = FP32_BWD_VARIANTS[name] is None  # no plan, no split
        tail = [p, f, f, p] if old else [p, f, f, p, p]
        lib.flash_attn_fp32_bwd_dq.argtypes = [p] * 8 + [i] * (5 if old else 8) + tail
        lib.flash_attn_fp32_bwd_dkv.argtypes = [p] * 10 + [i] * (5 if old else 8) + tail
        lib.flash_attn_fp32_bwd_dq.restype = lib.flash_attn_fp32_bwd_dkv.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, l, h, d, with_bias in FP32_BWD_SHAPES:
        q, k, v, do = (torch.randn((b, l, h * d), generator=gen, device="cuda")
                       for _ in range(4))
        bias = None
        if with_bias:
            bias = torch.where(torch.rand((b, l), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
            bias[0] = -1e30  # a fully masked batch row
        out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
        delta = fa.row_delta(out, do, h)
        pdq, pdk, pdv, _ = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        sc = d ** -0.5
        st_dq, st_dkv = fa._strides(q, k, v, do, dq), fa._strides(q, k, v, do, dk, dv)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), None if bias is None else bias.data_ptr())
        ws = torch.empty(fa.BWD_FP32_MAX_SPLIT * 2 * k.numel(), device="cuda")
        res = []
        for _ in range(2):
            for name in names:
                lib = libs["base" if name in FP32_BWD_PLANS else name]
                old = FP32_BWD_VARIANTS[name] is None
                (dq_plan, dkv_plan) = ((), ()) if old else fp32_bwd_plan(fa, name, b, l, h, d,
                                                                         sms)
                wsp = () if old else (ws.data_ptr(),)
                call_dq = lambda lib=lib, pl=dq_plan, wsp=wsp: lib.flash_attn_fp32_bwd_dq(
                    *ptrs, dq.data_ptr(), b, h, l, l, d, *pl, ctypes.addressof(st_dq),
                    sc * fa.LOG2E, sc, *wsp, stream)
                call_dkv = lambda lib=lib, pl=dkv_plan, wsp=wsp: lib.flash_attn_fp32_bwd_dkv(
                    *ptrs, dk.data_ptr(), dv.data_ptr(), None, b, h, l, l, d, *pl,
                    ctypes.addressof(st_dkv), sc * fa.LOG2E, sc, *wsp, stream)
                for t in (dq, dk, dv):
                    t.zero_()
                rc = (call_dq(), call_dkv())
                torch.cuda.synchronize()
                rels = [cs.kernel_errors(got, ref)[1]
                        for got, ref in ((dq, pdq), (dk, pdk), (dv, pdv))]
                plan = "" if old else f" dq {dq_plan} dkv {dkv_plan}"
                res.append(f"{name}{plan} dq {cs.time_ms(torch, call_dq):.4f} dk/dv "
                           f"{cs.time_ms(torch, call_dkv):.4f} ms (rc {rc}, rel L2 "
                           + "/".join(f"{r:.1e}" for r in rels) + ")")
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if bias is None else bias[:, None, None, :]
        o_lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=sc)
        sdpa_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh), do.unflatten(-1, (h, d)).transpose(1, 2), retain_graph=True))
        bounds = [cs.fp32_bound(b, l, l, h, d, exp2_rate, kind, with_bias)
                  for kind in ("dq", "dkv")]
        cs.say(f"[variants] fp32 bwd B{b} L{l} H{h} d{d} {'bias' if with_bias else 'no bias'}: "
               + "; ".join(res) + f"; sdpa fp32 backward {sdpa_ms:.4f} ms; bound dq "
               f"{bounds[0][0]:.4f} dk/dv {bounds[1][0]:.4f} ms ({bounds[0][1]}) [{card}]")
        del q, k, v, do, out, lse, delta, pdq, pdk, pdv, dq, dk, dv, ws, qh, kh, vh, o_lib


def main():
    import torch

    if "--fp32-bwd-model" in sys.argv[1:]:
        from adaface_tpu_torch.ops import flash_attention as fa

        return fp32_bwd_model(fa)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import flash_attention as fa

    args = sys.argv[1:]
    bwd, fp32, fp32_bwd = "--bwd" in args, "--fp32" in args, "--fp32-bwd" in args
    args = [a for a in args if a not in ("--bwd", "--fp32", "--fp32-bwd")]
    variants = (FP32_BWD_VARIANTS if fp32_bwd else FP32_VARIANTS if fp32 else
                BWD_VARIANTS if bwd else FWD_VARIANTS)
    names = args or list(variants)
    for name in names:
        if name not in variants:
            cs.fail(f"unknown variant {name}; known: {list(variants)}")
    card, exp2_rate = cs.phase_card(torch)
    if fp32_bwd:
        run_fp32_bwd(torch, fa, names, card, exp2_rate)
    elif fp32:
        run_fp32(torch, fa, names, card, exp2_rate)
    else:
        (run_backward if bwd else run_forward)(torch, fa, names, card)


if __name__ == "__main__":
    main()
