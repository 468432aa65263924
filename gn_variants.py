#!/usr/bin/env python3
"""Time variants of the GroupNorm+SiLU kernel (K8) side by side on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 gn_variants.py                 # every variant
    python3 gn_variants.py old base tanh   # some of them

Each variant is `adaface_tpu_torch/csrc/gn_silu.cu` with a few exact text
substitutions and, optionally, a change to the launch plan of
`ops/fused_norm.launch_plan` (both listed in VARIANTS), built by
`kernel_variants.build` into `_variants/gn_<name>/` (git-ignored) and called
through the same C interface as the port's wrapper. `old` is an older
kernel with its own C interface (two launches and a scratch of partial
sums): the `csrc/gn_silu.cu` of a tree unpacked into `_checkout/`
(git-ignored; e.g. `git archive <commit> | tar -x -C _checkout`).

At the 29 shapes of the fused generate and training paths
(`chip_smoke.GN_SHAPES`, `GN_TRAIN_SHAPES`) it prints, for two interleaved
rounds of all variants, each one's time (CUDA events, median of
back-to-back calls through the C entry), its device time (torch.profiler,
`chip_smoke.device_ms`), its return code and its relative L2 error against
the plain fp32 version (in the first round also the largest relative
error of an element where every pre-activation lies in [-12, -3],
`chip_smoke.gn_tail_inputs`, whose gate is GN_TAIL_REL_TOL), with its
launch plan and how many of its clusters the card holds at once
(cudaOccupancyMaxActiveClusters); then the default arm (the torch ops
the knob replaces), the bound (`chip_smoke.gn_bound`) and the base plan,
with the card's name and power limit. A variant that changes the function
(nonorm) exists to measure a cost, and its error is expected; so is the
tanh variant's tail error.
"""

import ctypes
import sys

import chip_smoke as cs
import kernel_variants as kv

DEPTH = "constexpr int DEPTH = 8;"
STORE = "      st8(os + (k - u) * step, norm8(raw[u], sc, sh, apply_silu));"
ST8 = "template <typename T>\n__device__ __forceinline__ void st8("
ADD8 = "template <typename T>\n__device__ __forceinline__ void add8("
# the first pass's loads ask L2 to keep x (evict_last), for the second
LD_LAST = [(ST8, "template <typename T>\n__device__ __forceinline__ Raw8<T> ld8_last(const T* p) {\n"
            "  Raw8<T> r;\n#pragma unroll\n  for (int i = 0; i < Raw8<T>::WORDS; ++i)\n"
            "    asm volatile(\"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_last.b64 "
            "pol, 1.0;\\nld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], pol;\\n}\\n\" : "
            "\"=r\"(r.w[i].x), \"=r\"(r.w[i].y), \"=r\"(r.w[i].z), \"=r\"(r.w[i].w) : "
            "\"l\"(reinterpret_cast<const uint4*>(p) + i));\n  return r;\n}\n\n" + ST8),
           ("    for (int u = 0; u < SUM_ROWS; ++u) raw[u] = ld8(xs + (k + u) * step);",
            "    for (int u = 0; u < SUM_ROWS; ++u) raw[u] = ld8_last(xs + (k + u) * step);")]
# the output stored with the evict-first (streaming) hint, so that it does
# not push x out of L2 before its second read
ST_CS = [(ADD8, "template <typename T>\n__device__ __forceinline__ void st8_cs(T* p, const Raw8<T>& r) {\n"
          "#pragma unroll\n  for (int i = 0; i < Raw8<T>::WORDS; ++i) "
          "__stcs(reinterpret_cast<uint4*>(p) + i, r.w[i]);\n}\n\n" + ADD8),
         (STORE, "      st8_cs(os + (k - u) * step, norm8(raw[u], sc, sh, apply_silu));")]
# every variant but `old` also exports how many of its clusters the card
# holds at once
RESIDENT = [('extern "C" int gn_silu_fwd(',
             """// The most clusters of `cluster` CTAs of `threads` threads that the card
// holds at once (cudaOccupancyMaxActiveClusters, at 32 groups), or minus a
// cudaError_t.
extern "C" int gn_silu_max_clusters(int cluster, int threads) {
  const cudaError_t attr = kernel_attributes();
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg =
      cluster_config(&at, cluster, 1, threads, smem_bytes(32, threads), nullptr);
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &count,
      threads <= MAX_THREADS ? gn_silu_kernel<bf16, MAX_THREADS> : gn_silu_kernel<bf16, WIDE_THREADS>,
      &cfg);
  return err != cudaSuccess ? -(int)err : count;
}

extern "C" int gn_silu_fwd(""")]
VARIANTS = {
    "old": ([], {}),
    "base": ([], {}),
    # SiLU as h + h tanh.approx(h): one MUFU operation fewer, but off in the
    # tail y << 0 (chip_smoke's planted fault)
    "tanh": (cs.GN_TANH_PATCHES, {}),
    # 4 loads in flight a thread as it sums too; 8 as it normalises (spills)
    "u4": ([(DEPTH, "constexpr int DEPTH = 4;")], {}),
    "n8": ([("constexpr int NORM_DEPTH = 4;", "constexpr int NORM_DEPTH = 8;")], {}),
    "ldlast": (LD_LAST, {}),
    "stcs": (ST_CS, {}),
    "l2hints": (LD_LAST + ST_CS, {}),
    # clusters of 16 at every shape
    "c16": ([], {"cluster": 16}),
    # no normalising pass (wrong output): the loads, sums and barriers alone
    "nonorm": ([("  k = nk - 1;\n", "  k = -1;\n")], {}),
}


def plan_for(fn, b, n, c, sms, cluster=None, threads=None):
    """The base plan with a cluster size or a thread target forced."""
    base = fn.launch_plan(b, n, c, sms)
    cluster = min(cluster or base.cluster, n)
    cv = c // 8
    threads = max(1, threads // cv) * cv if threads else base.threads
    return fn.LaunchPlan(cluster, threads)


def variant_specs(names):
    """name -> (source directory, source, patches) for `kernel_variants`."""
    return {name: (kv.OLD_CSRC, "gn_silu.cu", []) if name == "old"
            else (kv.CSRC, "gn_silu.cu", VARIANTS[name][0] + RESIDENT) for name in names}


def build(names):
    """Build the variants side by side; returns name -> library."""
    built = kv.build(variant_specs(names), prefix="gn_")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, (lib, log) in built.items():
        cs.say(f"[gn-variants] {name} ptxas: {kv.ptxas_lines(log)}")
        lib.gn_silu_fwd.argtypes = ([p] * 5 + [i] * 5 + [f, i, p]) if name == "old" else (
            [p] * 4 + [i] * 6 + [f, i, p])
        lib.gn_silu_fwd.restype = ctypes.c_int
        if name != "old":
            lib.gn_silu_max_clusters.argtypes = [i, i]
            lib.gn_silu_max_clusters.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.ops import fused_norm as fn

    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            cs.fail(f"unknown variant {name}; known: {list(VARIANTS)}")
    card, exp2_rate = cs.phase_card(torch)
    libs = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(9)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    shapes = sorted(set(cs.GN_SHAPES) | set(cs.GN_TRAIN_SHAPES),
                    key=lambda k: (-k[0], -k[1], k[2]))
    for b, n, c in shapes:
        label = f"B{b} N{n} C{c}"
        x, scale, bias = cs.gn_inputs(torch, randn, b, n, c)
        tail_in = cs.gn_tail_inputs(torch, gen, b, n, c)
        plain = fn.group_norm_silu_plain(x.float(), scale.float(), bias.float())
        tail_plain = fn.group_norm_silu_plain(*(t.float() for t in tail_in))
        out = torch.empty_like(x)
        old_rows = (-(-32768 // c) + 7) // 8 * 8
        partial = torch.empty((b, -(-n // old_rows), 2, 32), dtype=torch.float32, device="cuda")
        calls = {}
        for name, lib in libs.items():
            if name == "old":
                def call(xs=x, sc=scale, bi=bias, lib=lib):
                    return lib.gn_silu_fwd(xs.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                           partial.data_ptr(), out.data_ptr(), b, n, c, 32,
                                           old_rows, 1e-5, 1, stream)
                calls[name] = (call, "rows %d" % old_rows)
                continue
            plan = plan_for(fn, b, n, c, sms, **VARIANTS[name][1])

            def call(xs=x, sc=scale, bi=bias, lib=lib, plan=plan):
                return lib.gn_silu_fwd(xs.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                       out.data_ptr(), b, n, c, 32, plan.cluster, plan.threads,
                                       1e-5, 1, stream)
            resident = lib.gn_silu_max_clusters(plan.cluster, plan.threads)
            calls[name] = (call, f"cluster {plan.cluster} threads {plan.threads} resident "
                                 f"{resident}")
        res = []
        for rnd in range(2):
            for name, (call, desc) in calls.items():
                tail = ""
                if rnd == 0:
                    call(*tail_in)
                    torch.cuda.synchronize()
                    tail = f", tail {cs.gn_tail_error(out, tail_plain):.2e}"
                out.fill_(float("nan"))
                err = call()
                torch.cuda.synchronize()
                rel = ((out.float() - plain).norm() / plain.norm()).item()
                err_abs = (out.float() - plain).abs().max().item()
                ms = cs.time_ms(torch, call)
                dev = cs.device_ms(torch, call) if rnd == 0 else None
                res.append(f"{name} {ms:.4f} ms" + (f" device {dev:.4f}" if dev else "")
                           + f" (rc {err}, rel L2 {rel:.2e}, max abs {err_abs:.2e}{tail}, {desc})")
        default_ms = cs.time_ms(torch, lambda: fn._plain(x, scale, bias, 32, 1e-5, True))
        bound_ms, bound_by = cs.gn_bound(b, n, c, exp2_rate)
        cs.say(f"[gn-variants] {label}: " + "; ".join(res) + f"; default arm "
               f"{default_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
               f"{fn.launch_plan(b, n, c, sms)} [{card}]")
        del x, plain, out, partial, tail_in, tail_plain


if __name__ == "__main__":
    main()
