#!/usr/bin/env python3
"""Time variants of the Winograd conv kernel (K10) side by side on one card,
and break each one's time down by launch.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 wino_variants.py                 # every variant
    python3 wino_variants.py old base nov    # some of them
    python3 wino_variants.py --fp32          # every variant of the fp32 kernel
    python3 wino_variants.py --fp32 old base # the fp32 kernel against an older tree's

Each variant is `adaface_tpu_torch/csrc/winograd.cu` with a few exact text
substitutions and, optionally, a change to the launch plan of
`ops/winograd.launch_plan` (both listed in VARIANTS), built by
`kernel_variants.build` into `_variants/wino_<name>/` (git-ignored) and
called through the same C interface as the port's wrapper. `old` is an
older kernel with its own C interface (U [16, Cin_p, Cout_p], Cin_p a
multiple of 32): the `csrc/winograd.cu` of a tree unpacked into `_checkout/`
(git-ignored; e.g. `git archive <commit> | tar -x -C _checkout`).

At the 15 3x3 conv shapes of a generate UNet call that phase 4d of
`chip_smoke.py` drives, it prints for two interleaved rounds of all
variants each one's time (CUDA events, median of back-to-back calls), its
return code and its relative L2 error against the plain version; then
F.conv2d's time (cuDNN, channels_last bf16) and the bound
(`chip_smoke.wino_bound`); then each variant's device time by launch
(torch.profiler: the input transform, the products, the split sum), with
the card's name and power limit. Variants that change the function (nov,
nomma) exist to measure a cost, and their error is expected.
"""

import ctypes
import sys

import chip_smoke as cs
import kernel_variants as kv

SHAPES = [(8, 64, 64, 4, 320), (8, 64, 64, 320, 320), (16, 8, 8, 1280, 1280),
          (16, 16, 16, 640, 1280), (16, 16, 16, 1280, 1280), (16, 32, 32, 320, 640),
          (16, 32, 32, 640, 640), (16, 32, 32, 960, 640), (16, 32, 32, 1280, 640),
          (16, 32, 32, 1920, 640), (16, 64, 64, 320, 4), (16, 64, 64, 320, 320),
          (16, 64, 64, 640, 320), (16, 64, 64, 640, 640), (16, 64, 64, 960, 320)]
V_LOAD = "tma_load_2d(dst, map_v,"
VARIANTS = {
    "old": ([], {}),
    "base": ([], {}),
    # V's copies left out (the stage expects U's bytes only): the products
    # without the V slab's reads (wrong output)
    "nov": ([("mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);",
              "mbar_arrive_expect_tx(&full[stage], B_BYTES);"),
             (V_LOAD, "if (0) " + V_LOAD)], {}),
    # the products left out: what the copies and the epilogue take (wrong
    # output)
    "nomma": ([("wgmma_ss<BN>(m, da + 2 * kk, db + 2 * kk, (kk > 0 || s > st) ? 1 : 0);",
                "(void)da, (void)db;")], {}),
    # the copies left out (the stages' barriers complete without bytes): what
    # the products and the epilogue take alone (wrong output)
    "noload": ([("mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);", "mbar_arrive(&full[stage]);"),
                ("tma_load_2d(", "if (0) tma_load_2d(")], {}),
    # without setmaxnreg (every thread keeps the launch's 168 registers)
    "nomaxnreg": ([("  if (tid >= NCONS) {  // warpgroup 2\n    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(PRODUCER_REGS));\n",
                    "  if (tid >= NCONS) {  // warpgroup 2\n"),
                   ("    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(CONSUMER_REGS));\n", "")],
                  {}),
    # a ring of 4 or 6 stages (8 in the kernel)
    "stages4": ([("constexpr int STAGES = 8;", "constexpr int STAGES = 4;")], {}),
    "stages6": ([("constexpr int STAGES = 8;", "constexpr int STAGES = 6;")], {}),
    # the other grid order at every shape
    "mfast": ([], {"m_fastest": True}),
    "nfast": ([], {"m_fastest": False}),
    # no split, or split 2 / 4, at every shape
    "split1": ([], {"split": 1}),
    "split2": ([], {"split": 2}),
    "split4": ([], {"split": 4}),
}


def launch_name(key):
    """The K10 launch a profiler key names (mangled or demangled)."""
    for part, name in (("wino_input_kernel", "transform"), ("wino_product_kernel", "products"),
                       ("wino_split_sum", "split sum")):
        if part in key:
            return name
    return key[:40]


def variant_specs(names):
    """name -> (source directory, source, patches) for `kernel_variants`."""
    return {name: (kv.OLD_CSRC if name == "old" else kv.CSRC, "winograd.cu", VARIANTS[name][0])
            for name in names}


def build(names):
    """Build the variants side by side; returns name -> C entry."""
    fns = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in kv.build(variant_specs(names), prefix="wino_").items():
        cs.say(f"[wino-variants] {name} ptxas: {kv.ptxas_lines(log)}")
        fn = lib.winograd_conv3x3_fwd
        fn.argtypes = ([p] * 5 + [i] * 7 + [p]) if name == "old" else ([p] * 6 + [i] * 9 + [p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


# name -> (text patches, plan overrides), or None: the tree in _checkout/
FP32_VARIANTS = {
    "old": None,
    "base": ([], {}),
    # a copy ring of 3 slots (2 in the kernel)
    "ring3": ([("constexpr int RING = 2;", "constexpr int RING = 3;")], {}),
    # the narrow out path in CTAs of 256 threads (128 in the kernel); U's
    # loads fenced every 4 positions, or not at all (every 2 in the kernel)
    "nout256": ([("constexpr int OUT_THREADS = 128;", "constexpr int OUT_THREADS = 256;")], {}),
    "fence4": ([("      if (ij % 2 == 0) compiler_fence();", "      if (ij % 4 == 0) compiler_fence();")],
               {}),
    "nofence": ([("      if (ij % 2 == 0) compiler_fence();", "")], {}),
    # the narrow out team's width a compile-time constant (an argument in
    # the kernel, fixed to TEAM by the C entry)
    "team8": ([("  const int lane = threadIdx.x % 32, cs = lane % team;\n"
                "  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / team;",
                "  const int cs = threadIdx.x % TEAM;\n"
                "  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / TEAM;"),
               ("  for (int g = cs; g < Cin / 4; g += team) {",
                "  for (int g = cs; g < Cin / 4; g += TEAM) {"),
               ("  for (int o = 1; o < team; o <<= 1)", "  for (int o = 1; o < TEAM; o <<= 1)"),
               ("    if (q % team == cs)\n", "    if (q == cs)\n")], {"_narrow": True}),
    # the general path's split forced (s<split>)
    **{f"s{sp}": ([], {"split": sp, "_path": 0}) for sp in (1, 2, 3, 4, 6)},
    # the general path at the narrow shapes (plan's split there)
    "gen": ([], {"path": 0, "_narrow": True}),
}


def fp32_variant_specs(names):
    """name -> (source directory, source, patches) of the fp32 variants that
    build a source: plan overrides share `base`'s build."""
    specs = {}
    for name in names:
        v = FP32_VARIANTS[name]
        if v is None:
            specs[name] = (kv.OLD_CSRC, "winograd_fp32.cu", [])
        elif v[0] or name == "base":
            specs[name] = (kv.CSRC, "winograd_fp32.cu", v[0])
    return specs


def fp32_launch_name(key):
    """The fp32 K10 launch a profiler key names (mangled or demangled)."""
    for part, name in (("wino_input_fp32", "transform"), ("wino_product_fp32", "products (old)"),
                       ("wino32_product", "products"), ("wino32_split_sum", "split sum"),
                       ("wino32_narrow_in", "narrow in"), ("wino32_narrow_out", "narrow out")):
        if part in key:
            return name
    return key[:40]


def fp32_plan(tw, name, m, cin, cout, sms):
    """Variant `name`'s plan at one shape, or None where it forces what the
    shape's path does not take."""
    plan = tw.fp32_launch_plan(m, cin, cout, sms)
    over = dict(FP32_VARIANTS[name][1])
    want_path = over.pop("_path", None)
    if over.pop("_narrow", False) and plan.path == tw.FP32_GENERAL:
        return None
    if want_path is not None and plan.path != want_path:
        return None
    if "path" in over and over["path"] != plan.path:
        plan = tw.fp32_launch_plan(m, cin, cout, sms, path=over.pop("path"))
    plan = plan._replace(**over)
    return plan if tw.fp32_plan_ok(plan, cin, cout) else None


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


def sass_local(lib):
    """'function: LDL n, STL n' of each function of a built library that
    reads or writes local memory (cuobjdump -sass)."""
    import subprocess

    from adaface_tpu_torch import kernels

    sass = subprocess.run([kernels.cuda_tool("cuobjdump"), "-sass", lib._name],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    out, fn, counts = [], None, None
    for line in sass.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if fn and any(counts.values()):
                out.append(f"{fn[-40:]}: LDL {counts['LDL']}, STL {counts['STL']}")
            fn, counts = line.split("Function :")[-1].strip(), {"LDL": 0, "STL": 0}
        elif counts is not None:
            for op in counts:
                counts[op] += f" {op}" in line
    return "; ".join(out) or "none"


def run_fp32(torch, names, card):
    import flash_variants
    import torch.nn.functional as F

    from adaface_tpu_torch.ops import winograd as tw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (lib, log) in kv.build(fp32_variant_specs(names), prefix="wino32_").items():
        cs.say(f"[wino-variants] fp32 {name} ptxas: " + "; ".join(
            line for line in kv.ptxas_lines(log) if "registers" in line or "spill" in line))
        cs.say(f"[wino-variants] fp32 {name} SASS local memory: " + sass_local(lib))
        fn = lib.winograd_conv3x3_fp32_fwd
        fn.argtypes = ([p] * 5 + [i] * 7 + [p] if FP32_VARIANTS[name] is None
                       else tw.C_ENTRIES["winograd_conv3x3_fp32_fwd"][1])
        fn.restype = ctypes.c_int
        libs[name] = fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(19)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, w, cin, cout in SHAPES:
        label = f"B{b} {h}x{w} C{cin}->{cout}"
        m = b * h * w // 4
        x = randn(b, h, w, cin)
        kern = randn(3, 3, cin, cout) / (9 * cin) ** 0.5
        bias = 0.2 * randn(cout)
        u = tw.transform_weights(kern)
        plain = tw.winograd_conv3x3_plain(x, u, bias)
        out = torch.empty_like(plain)
        calls = {}
        if "old" in names:
            up_old = tw.padded_weights(u)
            cout_p, cin_p64 = up_old.shape[1], up_old.shape[2]
            v_old = torch.empty((16, m, cin_p64), device="cuda")
            calls["old"] = (lambda fn=libs["old"]: fn(
                x.data_ptr(), up_old.data_ptr(), bias.data_ptr(), v_old.data_ptr(),
                out.data_ptr(), b, h, w, cin, cout, cin_p64, cout_p, stream), "no plan")
        if any(n != "old" for n in names):
            ut = tw.padded_weights_fp32(u)
            cin_p = ut.shape[2]
            v = torch.empty((16, m, cin_p), device="cuda")
            ws = torch.empty((tw.FP32_MAX_SPLIT, 4, m, cout), device="cuda")
            for name in names:
                if name == "old":
                    continue
                plan = fp32_plan(tw, name, m, cin, cout, sms)
                if plan is None:
                    continue
                fn = libs[name] if name in libs else libs["base"]
                calls[name] = (lambda fn=fn, plan=plan: fn(
                    x.data_ptr(), ut.data_ptr(), bias.data_ptr(), v.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), b, h, w, cin, cout, cin_p, *plan, stream), tuple(plan))
        res = []
        for _ in range(2):
            for name, (call, plan) in calls.items():
                out.fill_(float("nan"))
                rc = call()
                torch.cuda.synchronize()
                err, rel = cs.fused_fp32_errors(out, plain)
                res.append(f"{name} {cs.time_ms(torch, call):.4f} ms (rc {rc}, rel L2 {rel:.2e}, "
                           f"max {err:.2e}; {plan})")
        plain_ms = cs.time_ms(torch, lambda: tw.winograd_conv3x3_plain(x, u, bias), reps=2,
                              rounds=3)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels_last NCHW
        wc = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = cs.time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        bound_ms, bound_by = cs.wino_bound(b, h, w, cin, cout, itemsize=4,
                                           peak=cs.PEAK_FP32_FLOPS)
        cs.say(f"[wino-variants] fp32 {label}: " + "; ".join(res) + f"; plain {plain_ms:.4f} ms; "
               f"F.conv2d fp32 {lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        for name, (call, _) in calls.items():
            cs.say(f"[wino-variants] fp32 {name} by launch, {label}: " + by_launch(torch, call)
                   + f" [{card}]")
        if (b, h, w, cin, cout) == SHAPES[1] and calls:
            first = "base" if "base" in calls else next(iter(calls))
            cs.say(f"[wino-variants] fp32 {first} {label}: "
                   + flash_variants.clock_under_load(torch, calls[first][0]) + f" [{card}]")
        del x, plain, out, calls


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import winograd as tw

    if "--fp32" in sys.argv[1:]:
        names = [a for a in sys.argv[1:] if a != "--fp32"] or list(FP32_VARIANTS)
        for name in names:
            if name not in FP32_VARIANTS:
                cs.fail(f"unknown fp32 variant {name}; known: {list(FP32_VARIANTS)}")
        if any(FP32_VARIANTS[n] is not None and not FP32_VARIANTS[n][0] for n in names):
            names += [] if "base" in names else ["base"]  # the plan overrides' build
        card, _ = cs.phase_card(torch)
        return run_fp32(torch, names, card)
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            cs.fail(f"unknown variant {name}; known: {list(VARIANTS)}")
    card, _ = cs.phase_card(torch)
    fns = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(19)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, w, cin, cout in SHAPES:
        label = f"B{b} {h}x{w} C{cin}->{cout}"
        x = randn(b, h, w, cin).bfloat16()
        kern = (randn(3, 3, cin, cout) / (9 * cin) ** 0.5).bfloat16()
        bias = (0.2 * randn(cout)).bfloat16()
        u = tw.transform_weights(kern)
        plain = tw.winograd_conv3x3_plain(x, u, bias).float()
        m = b * h * w // 4
        ut = tw.padded_weights(u)
        cout_p, cin_p = ut.shape[1], ut.shape[2]
        cin_p32 = -(-cin // 32) * 32
        up_old = F.pad(u, (0, cout_p - cout, 0, cin_p32 - cin)).contiguous()
        base_plan = tw.launch_plan(m, cin, cout, sms)
        v = torch.empty((16, m, cin_p), dtype=torch.bfloat16, device="cuda")
        out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device="cuda")
        plans = {name: base_plan._replace(**VARIANTS[name][1]) for name in fns}
        ws = torch.empty((max(pl.split for pl in plans.values()), 4, m, cout_p),
                         dtype=torch.float32, device="cuda")
        calls = {}
        for name, fn in fns.items():
            plan = plans[name]
            if name == "old":
                def call(fn=fn):
                    return fn(x.data_ptr(), up_old.data_ptr(), bias.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, h, w, cin, cout, cin_p32, cout_p, stream)
            else:
                def call(fn=fn, plan=plan):
                    return fn(x.data_ptr(), ut.data_ptr(), bias.data_ptr(), v.data_ptr(),
                              ws.data_ptr(), out.data_ptr(), b, h, w, cin, cout, cin_p, cout_p,
                              plan.split, int(plan.m_fastest), stream)
            calls[name] = (call, plan)
        res = []
        for _ in range(2):
            for name, (call, plan) in calls.items():
                out.fill_(float("nan"))
                err = call()
                torch.cuda.synchronize()
                rel = ((out.float() - plain).norm() / plain.norm()).item()
                res.append(f"{name} {cs.time_ms(torch, call):.4f} ms (rc {err}, rel L2 "
                           f"{rel:.2e}, split {plan.split}{' m' if plan.m_fastest else ''})")
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels_last NCHW
        wc = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = cs.time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        bound_ms, bound_by = cs.wino_bound(b, h, w, cin, cout)
        cs.say(f"[wino-variants] {label}: " + "; ".join(res) + f"; F.conv2d {lib_ms:.4f} ms; "
               f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        for name, (call, _) in calls.items():
            call()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            parts = [f"{launch_name(e.key)} {dev(e) / e.count / 1e3:.4f} ms"
                     for e in prof.key_averages() if dev(e) > 0
                     and str(getattr(e, "device_type", "")).endswith("CUDA")]
            cs.say(f"[wino-variants] {name} by launch, {label}: " + "; ".join(parts)
                   + f" [{card}]")
        del x, v, out, ws, plain, ut, up_old


if __name__ == "__main__":
    main()
