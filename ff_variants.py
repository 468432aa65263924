#!/usr/bin/env python3
"""Time variants of the LayerNorm + GEGLU feed-forward kernel (K9) side by
side on one card, and break the kernel's time down by launch.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 ff_variants.py                 # every variant
    python3 ff_variants.py base tanhf      # some of them

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


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import fused_ff as ff

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
