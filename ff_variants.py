#!/usr/bin/env python3
"""Time variants of the LayerNorm + GEGLU feed-forward kernel (K9) side by
side on one card, and break the kernel's time down by launch.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 ff_variants.py                 # every variant
    python3 ff_variants.py base tanhf      # some of them
    python3 ff_variants.py --fp32          # every variant of the fp32 kernel
    python3 ff_variants.py --fp32 old base # the fp32 kernel against an older tree's

Each variant is `adaface_tpu_torch/csrc/ln_geglu_ff.cu` with a few exact
text substitutions and, optionally, a change to the launch plan of
`ops/fused_ff.launch_plan` (both listed in VARIANTS), built by
`kernel_variants.build` into `_variants/ff_<name>/` (git-ignored) and
called through the same C interface as the port's wrapper. At the six shapes
of the fused generate and training paths it prints, for two interleaved
rounds of all variants, each one's time (CUDA events, median of
back-to-back calls), its return code and the relative L2 error of its
feed-forward part against the plain fp32 version; then the device time of
each launch of the base variant (torch.profiler), with the card's name and
power limit. Variants that change the function (nogelu) exist to measure a
cost, and their error is expected.

`--fp32`: the fp32 kernel `csrc/ln_geglu_ff_fp32.cu` at the eight shapes of
the fused fp32 paths (FP32_SHAPES), its variants in FP32_VARIANTS (text
patches and plan overrides of `ops/fused_ff.fp32_launch_plan`; a forced
GEMM2 width that does not divide C is left out at that shape); `old` is the
kernel of the tree unpacked into `_checkout/` (`git archive <commit> | tar
-x -C _checkout`), called through its C interface from before the plan.
Two interleaved rounds of every variant (CUDA events, median of
back-to-back calls, return code, relative L2 and max abs error of out - x
against the plain fp32 version, the plan), then the unfused fp32 chain, the
FFMA bound, and, by torch.profiler, the device time of each launch of
`base` and of `old` beside cuBLAS's SGEMM of each GEMM's [M, N, K] (TF32
off), with the SM clock and power that nvidia-smi reads under load.
"""

import ctypes
import sys

import chip_smoke as cs
import kernel_variants as kv

SHAPES = list(cs.FF_SHAPES) + list(cs.FF_TRAIN_SHAPES)
GELU = "  return __fdividef(v, 1.f + __expf(-u2));"
VARIANTS = {
    "base": ([], {}),
    # the accurate tanhf of the reference formula
    "tanhf": ([(GELU, "  return 0.5f * v * (1.f + tanhf(0.5f * u2));")], {}),
    # GELU left out of GEGLU (h = a * g): what its arithmetic costs (wrong
    # output)
    "nogelu": ([("__floats2bfloat162_rn(gelu_tanh(g.x), gelu_tanh(g.y))",
                 "__floats2bfloat162_rn(g.x, g.y)")], {}),
    # the epilogue warps' row loop unrolled by 1 or 4 (2 in the kernel)
    "unroll1": ([("#pragma unroll 2\n      for (int r = e / CHV", "#pragma unroll 1\n      for (int r = e / CHV")], {}),
    "unroll4": ([("#pragma unroll 2\n      for (int r = e / CHV", "#pragma unroll 4\n      for (int r = e / CHV")], {}),
    # the products left out (consumers wait for each stage and release it):
    # what the copies alone take (wrong output)
    "nomma": ([("wgmma_ss<N>(acc[j], da + 2 * kk, db + 2 * kk, (ks > w.k0 || kk > 0) ? 1 : 0);",
                "(void)da, (void)db;")], {}),
    # the copies left out (the stages' barriers complete without bytes): what
    # the products alone take (wrong output)
    "noload": ([("mbar_arrive_expect_tx(&full[st], G::STAGE_BYTES);", "mbar_arrive(&full[st]);"),
                ("tma_load_2d(", "if (0) tma_load_2d(")], {}),
    # rings of at most 4 stages (GEMM1 has 3 at 128 columns, GEMM2 6)
    "stages4": ([("FIT < 6 ? FIT : 6", "FIT < 4 ? FIT : 4")], {}),
    # GEMM2 tiles of 128 rows at every shape
    "rows128": ([], {"rows2": 128}),
    # GEMM2 split in 2 / 4 at every shape
    "split2": ([], {"split": 2}),
    "split4": ([], {"split": 4}),
    # GEMM1 tiles of 64 h columns (a B tile of 128 rows, 5 stages)
    "bn1_64": ([], {"bn1": 64}),
}


def launch_name(key):
    """The K9 launch a profiler key names (mangled or demangled)."""
    for part, name in (("ln_kernel", "layernorm"), ("gemm_kernel<0", "gemm1"),
                       ("gemm_kernelILi0", "gemm1"), ("gemm_kernel<1", "gemm2"),
                       ("gemm_kernelILi1", "gemm2"), ("splitk_reduce", "split-K sum")):
        if part in key:
            return name
    return key[:40]


def variant_specs(names):
    """name -> (source directory, source, patches) for `kernel_variants`."""
    return {name: (kv.CSRC, "ln_geglu_ff.cu", VARIANTS[name][0]) for name in names}


def build(names):
    """Build the variants side by side; returns name -> C entry."""
    fns = {}
    for name, (lib, log) in kv.build(variant_specs(names), prefix="ff_").items():
        spills = [line for line in kv.ptxas_lines(log) if "spill" in line]
        if spills:
            cs.say(f"[variants] {name} spills: {spills}")
        fn = lib.ln_geglu_ff_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 3 + [ctypes.c_float] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


# the fp32 kernel's shapes: the fused fp32 request's (B16), 9e's recon (B3)
# and compos (B4) micro-steps'
FP32_SHAPES = list(cs.FF_SHAPES) + list(cs.FF_TRAIN_SHAPES) + list(cs.FF_COMPOS_SHAPES)
# name -> (text patches, plan overrides), or None: the tree in _checkout/
FP32_VARIANTS = {
    "old": None,
    "base": ([], {}),
    # GELU left out of GEGLU (h = a * g): what its tanhf costs (wrong output)
    "nogelu": ([("  return 0.5f * g * (1.f + tanhf(inner));", "  return g;")], {}),
    # stages of 8 K columns (half the products a barrier)
    "bk8": ([("constexpr int BK = 16;", "constexpr int BK = 8;")], {}),
    # no cap of 128 registers on GEMM1 and 64-column GEMM2 tiles either
    "cta1": ([("EPI == EPI_GEGLU || BN == 64 ? 2 : 1", "1")], {}),
    # 160-column GEMM2 tiles capped at 128 registers (two CTAs an SM), unsplit
    # and split 2
    "c160x2": ([("EPI == EPI_GEGLU || BN == 64 ? 2 : 1", "EPI == EPI_GEGLU || BN != 128 ? 2 : 1")],
               {"bn2": 160}),
    "c160x2s2": ([("EPI == EPI_GEGLU || BN == 64 ? 2 : 1",
                   "EPI == EPI_GEGLU || BN != 128 ? 2 : 1")], {"bn2": 160, "split": 2}),
    # copy rings of 2 and 4 slots (1 and 3 stages in flight; 2 in the kernel)
    "ring2": ([("constexpr int RING = 3;", "constexpr int RING = 2;")], {}),
    "ring4": ([("constexpr int RING = 3;", "constexpr int RING = 4;")], {}),
    # GEMM2's tile width and split forced (w<width>s<split>)
    **{f"w{bn}s{sp}": ([], {"bn2": bn, "split": sp}) for bn in (64, 128, 160)
       for sp in (1, 2, 3, 4)},
}


def fp32_variant_specs(names):
    """name -> (source directory, source, patches) of the fp32 variants that
    build a source: plan overrides share `base`'s build."""
    specs = {}
    for name in names:
        v = FP32_VARIANTS[name]
        if v is None:
            specs[name] = (kv.OLD_CSRC, "ln_geglu_ff_fp32.cu", [])
        elif v[0] or name == "base":
            specs[name] = (kv.CSRC, "ln_geglu_ff_fp32.cu", v[0])
    return specs


def fp32_launch_name(key):
    """The fp32 K9 launch a profiler key names (mangled or demangled)."""
    for part, name in (("ln_kernel", "layernorm"), ("gemm_kernel<0", "gemm1"),
                       ("gemm_kernelILi0", "gemm1"), ("gemm_kernel<1", "gemm2"),
                       ("gemm_kernelILi1", "gemm2"), ("gemm_kernel<2", "gemm2 partials"),
                       ("gemm_kernelILi2", "gemm2 partials"), ("split_sum", "split sum")):
        # the older kernel (`old`) and ff32_ln_kernel, ff32_gemm_kernel, ...
        if part in key:
            return name
    return key[:40]


def fp32_plan(ff, name, m, c, f, sms):
    """Variant `name`'s plan at one shape, or None where its forced width
    does not divide C."""
    plan = ff.fp32_launch_plan(m, c, f, sms)._replace(**FP32_VARIANTS[name][1])
    return None if c % plan.bn2 else plan


def by_launch(torch, call, reps=10):
    """'name ms xN' of each launch of call(), device time by torch.profiler
    over `reps` calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    parts = [(fp32_launch_name(e.key), dev(e) / reps / 1e3, e.count // reps)
             for e in prof.key_averages() if dev(e) > 0
             and str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(ms for _, ms, _ in parts)
    return "; ".join(f"{n} {ms:.4f} ms x{k}" for n, ms, k in parts) + f" (sum {total:.4f} ms)"


def run_fp32(torch, names, card):
    import flash_variants
    import torch.nn.functional as F

    from adaface_tpu_torch.ops import fused_ff as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, (lib, log) in kv.build(fp32_variant_specs(names), prefix="ff32_").items():
        cs.say(f"[variants] fp32 {name} ptxas: " + "; ".join(
            line for line in kv.ptxas_lines(log) if "registers" in line or "spill" in line))
        fn = lib.ln_geglu_ff_fp32_fwd
        fn.argtypes = ([p] * 10 + [i] * 3 + [fl, p] if FP32_VARIANTS[name] is None
                       else ff.C_ENTRIES["ln_geglu_ff_fp32_fwd"][1])
        fn.restype = ctypes.c_int
        libs[name] = fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b, l, c in FP32_SHAPES:
        m, f = b * l, 4 * c
        x = randn(b, l, c)
        ln_g, ln_b = 1 + 0.2 * randn(c), 0.2 * randn(c)
        w1t, b1 = randn(2 * f, c) / c ** 0.5, 0.2 * randn(2 * f)
        w2t, b2 = randn(c, f) / f ** 0.5, 0.2 * randn(c)
        args = (x, ln_g, ln_b, w1t.t(), b1, w2t.t(), b2)
        plain = ff.ln_geglu_ff_plain(*args)
        y, h, out = torch.empty_like(x), x.new_empty((m, f)), torch.empty_like(x)
        ws = torch.empty((ff.FP32_MAX_SPLIT, m, c), device="cuda")
        head = (x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                w2t.data_ptr(), b2.data_ptr(), y.data_ptr(), h.data_ptr())
        calls = {}
        for name in names:
            if FP32_VARIANTS[name] is None:
                calls[name] = (lambda fn=libs[name]: fn(*head, out.data_ptr(), m, c, f, 1e-5,
                                                         stream), "no plan")
                continue
            plan = fp32_plan(ff, name, m, c, f, sms)
            if plan is None:
                continue
            fn = libs[name] if name in libs else libs["base"]
            calls[name] = (lambda fn=fn, plan=plan: fn(*head, ws.data_ptr(), out.data_ptr(), m,
                                                       c, f, 1e-5, *plan, stream), plan)
        res = []
        for _ in range(2):
            for name, (call, plan) in calls.items():
                out.fill_(float("nan"))
                rc = call()
                torch.cuda.synchronize()
                err, rel = cs.fused_fp32_errors(out, plain, x)
                res.append(f"{name} {cs.time_ms(torch, call):.4f} ms (rc {rc}, rel L2 {rel:.2e}, "
                           f"max {err:.2e}; {tuple(plan) if plan != 'no plan' else plan})")
        unfused_ms = cs.time_ms(torch, lambda: ff.ln_geglu_ff_unfused(*args))
        bound_ms, bound_by = cs.ff_bound(b, l, c, itemsize=4, peak=cs.PEAK_FP32_FLOPS)
        cs.say(f"[variants] fp32 B{b} L{l} C{c}: " + "; ".join(res)
               + f"; unfused fp32 chain {unfused_ms:.4f} ms; bound {bound_ms:.4f} ms "
               f"({bound_by}) [{card}]")
        yl = F.layer_norm(x, (c,), ln_g, ln_b).view(m, c)
        hl = randn(m, f)
        sg1 = cs.time_ms(torch, lambda: F.linear(yl, w1t))
        sg2 = cs.time_ms(torch, lambda: F.linear(hl, w2t))
        for name in ("old", "base"):
            if name in calls:
                cs.say(f"[variants] fp32 {name} by launch, B{b} L{l} C{c}: "
                       + by_launch(torch, calls[name][0]) + f"; cuBLAS SGEMM [{m}, {2 * f}, {c}] "
                       f"{sg1:.4f} ms, [{m}, {c}, {f}] {sg2:.4f} ms [{card}]")
        if (b, l, c) == FP32_SHAPES[0] and "base" in calls:
            cs.say(f"[variants] fp32 base B{b} L{l} C{c}: "
                   + flash_variants.clock_under_load(torch, calls["base"][0]) + f" [{card}]")
        del x, y, h, out, ws, plain, w1t, w2t, yl, hl, args


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import fused_ff as ff

    if "--fp32" in sys.argv[1:]:
        names = [a for a in sys.argv[1:] if a != "--fp32"] or list(FP32_VARIANTS)
        for name in names:
            if name not in FP32_VARIANTS:
                cs.fail(f"unknown fp32 variant {name}; known: {list(FP32_VARIANTS)}")
        if "base" not in names:
            names.append("base")  # the plan overrides' build
        card, _ = cs.phase_card(torch)
        return run_fp32(torch, names, card)
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            cs.fail(f"unknown variant {name}; known: {list(VARIANTS)}")
    card, _ = cs.phase_card(torch)
    fns = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b, l, c in SHAPES:
        m, f = b * l, 4 * c
        x = randn(b, l, c).bfloat16()
        ln_g, ln_b = (1 + 0.2 * randn(c)).bfloat16(), (0.2 * randn(c)).bfloat16()
        w1t, b1 = (randn(2 * f, c) / c ** 0.5).bfloat16(), (0.2 * randn(2 * f)).bfloat16()
        w2t, b2 = (randn(c, f) / f ** 0.5).bfloat16(), (0.2 * randn(c)).bfloat16()
        plain = ff.ln_geglu_ff_plain(*(t.float() for t in (x, ln_g, ln_b, w1t.t(), b1,
                                                            w2t.t(), b2)))
        y, h, out = torch.empty_like(x), x.new_empty((m, f)), torch.empty_like(x)
        base_plan = ff.launch_plan(m, c, f, sms)
        ws = torch.empty((ff.MAX_SPLIT, m, c), dtype=torch.float32, device="cuda")
        calls = {}
        for name, fn in fns.items():
            plan = base_plan._replace(**VARIANTS[name][1])
            plan = plan._replace(  # the grids, for the plan's tiles and split
                grid1=min(-(-m // ff.GEMM1_ROWS) * f // plan.bn1, sms),
                grid2=min(-(-m // plan.rows2) * c // plan.bn2 * plan.split, sms))

            def call(fn=fn, plan=plan):
                return fn(x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(),
                          b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), y.data_ptr(),
                          h.data_ptr(), ws.data_ptr(), out.data_ptr(), m, c, f, 1e-5, *plan,
                          stream)
            calls[name] = (call, plan)
        res = []
        for _ in range(2):
            for name, (call, plan) in calls.items():
                err = call()
                torch.cuda.synchronize()
                _, rel = cs.ff_errors(out, plain, x)
                res.append(f"{name} {cs.time_ms(torch, call):.4f} ms (rc {err}, rel L2 "
                           f"{rel:.2e}, split {plan.split})")
        cs.say(f"[variants] B{b} L{l} C{c}: " + "; ".join(res) + f" [{card}]")
        call = calls[names[0]][0]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        parts = [f"{launch_name(e.key)} {dev(e) / e.count / 1e3:.4f} ms x{e.count // 10}"
                 for e in prof.key_averages() if dev(e) > 0
                 and str(getattr(e, "device_type", "")).endswith("CUDA")]
        cs.say(f"[variants] {names[0]} by launch, B{b} L{l} C{c}: " + "; ".join(parts)
               + f" [{card}]")
        del x, y, h, out, ws, plain, w1t, w2t


if __name__ == "__main__":
    main()
