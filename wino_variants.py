#!/usr/bin/env python3
"""Time variants of the Winograd conv kernel (K10) side by side on one card,
and break each one's time down by launch.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 wino_variants.py                 # every variant
    python3 wino_variants.py old base nov    # some of them

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


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import winograd as tw

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
