#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (`adaface_tpu_torch`) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
  2. build: every CUDA kernel from `adaface_tpu_torch/csrc/`, with nvcc;
  3. kernel vs plain: the packed flash-attention kernel against its plain
     fp32 PyTorch version at every main-path shape, a fused-qkv input and a
     key bias with a fully masked row, each gated on max abs and relative L2
     error; planted faults must fail the same gate; kernel, plain and SDPA
     times;
  4. reference: the SD-width CLIP, UNet and VAE in bf16 on the card against
     the same weights in fp32 on the CPU, on a small input;
  5. main path: `StableDiffusionPipeline.generate` at SD-v1.5 width, batch 8,
     512x512, DDIM-50, CFG 10->4, bf16, random weights, one 9-vector subject
     placeholder: one warm-up and 3 timed requests, each of which must launch
     the kernel exactly 750 times;
  6. profile: stage times, and device time by kernel category and the
     device's idle share for one whole request.
The last lines are one JSON object per kernel list, the card line, and
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the package
beside it, the script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
MUFU_EXP2_PER_CLOCK_PER_SM = 16  # CUDA programming guide, compute capability 9.0
# Kernel vs plain gate. With randn q, k, v each score is about N(0, 1), so the
# output is small (std about 0.026 at L4096, 0.05 at L1024, 0.10 at L256) and
# a loose absolute limit would pass a wrong kernel. The gate holds both the
# relative L2 error ||out - plain|| / ||plain|| and the max abs error per head
# dim (bf16 rounding of o and of the probabilities measured 1e-3..3e-3 abs on
# an H100). Planted faults (one 64-key tile skipped, a wrong softmax scale)
# must fail it, and the script checks that they do.
KERNEL_REL_TOL = 1e-2
KERNEL_ABS_TOL = {40: 5e-3, 80: 5e-3, 160: 1e-2}
MASKED_ROW_TOL = 1e-3  # the fully masked row vs the uniform average of v
# relative L2 error, bf16 on the card vs fp32 on the CPU through whole models;
# it grows with depth (measured on an H100: CLIP 1.0e-2, UNet 1.6e-2, VAE
# decoder 3.5e-2 with its ~30 convs at up to 512 channels)
REFERENCE_TOL = {"clip": 5e-2, "unet eps": 5e-2, "vae decode": 1e-1}
STEPS, BATCH, SIZE = 50, 8, 512
PROMPT = "a photo of a z , , , , , , , , person"
SOURCE = "adaface_tpu_torch/csrc/flash_attn_packed.cu"
K1 = "adaface_tpu/ops/flash_attention.py:578"  # _flash_kernel_heads_pvt
K4 = "adaface_tpu/ops/flash_attention.py:544"  # _flash_kernel_heads_short
# (B, L, H, d) -> (TPU kernel replaced, launches per generate call)
MAIN_SHAPES = {
    (16, 4096, 8, 40): (K1, 200),
    (8, 4096, 8, 40): (K1, 50),   # CFG stem dedup: layer 1 runs at batch B
    (16, 1024, 8, 80): (K1, 250),
    (16, 256, 8, 160): (K4, 250),
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def time_ms(torch, fn, reps=10, rounds=10, warmup=2):
    """Median over `rounds` of the CUDA-event time of `reps` back-to-back
    calls of fn(), divided by `reps`, after warm-up. Back-to-back calls keep
    the device queue full, so a short kernel is not timed at the host's
    launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(b, lq, lk, h, d, exp2_rate, with_bias):
    dp = (d + 15) // 16 * 16
    t_mma = 4 * b * h * lq * lk * dp / PEAK_BF16_FLOPS
    t_exp = b * h * lq * lk / exp2_rate
    nbytes = 2 * h * d * (2 * b * lq + 2 * b * lk) + (4 * b * lk if with_bias else 0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_mma, t_exp, t_bytes) * 1e3, ("bytes" if t_bytes >= max(t_mma, t_exp)
                                               else "operations")


def phase_card(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, power, max_sm_mhz = [s.strip() for s in smi.stdout.splitlines()[0].split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} devices {torch.cuda.device_count()} max SM clock "
        f"{max_sm_mhz} MHz; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp2_rate = sms * MUFU_EXP2_PER_CLOCK_PER_SM * float(max_sm_mhz) * 1e6
    return card, exp2_rate


def phase_build(kernels):
    t0 = time.time()
    log = kernels.build()
    say(f"[build] {time.time() - t0:.1f} s, libraries {[p.name for p in kernels.BUILD_DIR.glob('*.so')]}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say(f"[build]   {line.strip()}")


def kernel_errors(out, plain):
    """(max abs error, relative L2 error) of a kernel output against fp32."""
    diff = out.float() - plain
    return diff.abs().max().item(), (diff.norm() / plain.norm()).item()


def gate_passes(out, plain, d):
    err, rel = kernel_errors(out, plain)
    return err <= KERNEL_ABS_TOL[d] and rel <= KERNEL_REL_TOL


def check_gate_rejects_faults(fa, q, k, v, h, d, bias, plain, label):
    """Planted faults, made with the plain version and rounded to bf16 like a
    kernel output: one 64-key tile skipped, and the softmax scale of head dim
    d + 8. The gate must reject both, or it could pass a wrong kernel."""
    kb = None if bias is None else bias[:, 64:]
    faults = {
        "key tile 0 skipped": fa.flash_attention_blc_plain(q, k[:, 64:], v[:, 64:], h,
                                                           key_bias=kb),
        f"scale of d{d + 8}": fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias,
                                                           scale=(d + 8) ** -0.5),
    }
    for name, wrong in faults.items():
        err, rel = kernel_errors(wrong.bfloat16(), plain)
        say(f"[kernel]   planted fault, {name}: max abs err {err:.3e} rel L2 {rel:.3e}")
        if gate_passes(wrong.bfloat16(), plain, d):
            fail(f"{label}: the gate passes a planted fault ({name})")


def phase_kernels(torch, fa, card, exp2_rate):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    rows = {}
    cases = [(shape, "packed") for shape in MAIN_SHAPES] + [
        ((16, 1024, 8, 80), "fused-qkv"), ((4, 4096, 8, 40), "bias, row 0 fully masked")]
    for (b, l, h, d), kind in cases:
        inner = h * d
        bias = None
        if kind == "fused-qkv":
            qkv = rand(b, l, 3 * inner)
            q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
        else:
            q, k, v = rand(b, l, inner), rand(b, l, inner), rand(b, l, inner)
        if kind.startswith("bias"):
            bias = torch.zeros((b, l), device="cuda")
            bias[0] = -1e30
            bias[1:, torch.rand(l, generator=gen, device="cuda") > 0.6] = -1e30
        fa.launches = 0
        out = fa.flash_attention_blc_cuda(q, k, v, h, key_bias=bias)
        torch.cuda.synchronize()
        if fa.launches != 1:
            fail(f"kernel wrapper counted {fa.launches} launches for one call")
        plain = fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias)
        if not torch.isfinite(out).all():
            fail(f"{kind} B{b} L{l} H{h} d{d}: non-finite kernel output")
        err, rel = kernel_errors(out, plain)
        label = f"{kind} B{b} L{l} H{h} d{d}"
        if bias is not None:
            uniform = v[0].float().mean(0)  # the masked row attends evenly
            err_u = (out[0].float() - uniform).abs().max().item()
            say(f"[kernel] masked row vs uniform average of v: max abs err {err_u:.3e} "
                f"(tol {MASKED_ROW_TOL})")
            if not err_u <= MASKED_ROW_TOL:
                fail("fully masked row is not uniform")
        ms = time_ms(torch, lambda: fa.flash_attention_blc_cuda(q, k, v, h, key_bias=bias))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias))
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=d ** -0.5))
        bound_ms, bound_by = bound(b, l, l, h, d, exp2_rate, bias is not None)
        fa.launches = 0
        fa.launches_by_shape.clear()
        say(f"[kernel] {label:44s}: max abs err {err:.3e} (tol {KERNEL_ABS_TOL[d]}) "
            f"rel L2 {rel:.3e} (tol {KERNEL_REL_TOL}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) [{card}]")
        if not gate_passes(out, plain, d):
            fail(f"{label}: kernel disagrees with plain (max abs {err:.3e}, rel L2 {rel:.3e})")
        check_gate_rejects_faults(fa, q, k, v, h, d, bias, plain, label)
        if kind == "packed":
            rows[(b, l, h, d)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=library_ms)
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return rows


def rel_err(a, b):
    return ((a.float().cpu() - b.float()).norm() / b.float().norm()).item()


def phase_reference(torch, pipe):
    """SD-width models, bf16 on the card vs fp32 on the CPU, same weights."""
    from adaface_tpu_torch.models.unet import precompute_cross_kv

    def cpu_copy(m):
        with torch.device("meta"):
            c = type(m)(m.cfg)
        c = c.to_empty(device="cpu")
        c.load_state_dict({k: v.float().cpu() for k, v in m.state_dict().items()})
        return c.eval()

    gen = torch.Generator().manual_seed(1)
    ids = pipe.tokenizer(["a photo of a z , , , , , , , , person", "a red car"])
    x = torch.randn((1, 16, 16, 4), generator=gen)  # level 0 self-attention: L 256
    t = torch.tensor([501], dtype=torch.int32)
    z = torch.randn((1, 16, 16, 4), generator=gen)
    with torch.inference_mode():
        ctx_gpu = pipe.clip(torch.as_tensor(ids, device="cuda").long(), skip_weights=(0.5, 0.5))
        clip_cpu = cpu_copy(pipe.clip)
        ctx_cpu = clip_cpu(torch.as_tensor(ids).long(), skip_weights=(0.5, 0.5))
        del clip_cpu
        ctx = ctx_cpu[None]  # [1, 2B, 77, 768]: (cond; uncond) for B = 1
        unet_cpu = cpu_copy(pipe.unet)
        eps_cpu = unet_cpu(x, t, ctx, cfg_dedup=True, cross_kv=precompute_cross_kv(unet_cpu, ctx))
        del unet_cpu
        fa_launches = _fa().launches
        ctx_d = ctx.cuda().to(torch.bfloat16)
        eps_gpu = pipe.unet(x.cuda(), t.cuda(), ctx_d, cfg_dedup=True,
                            cross_kv=precompute_cross_kv(pipe.unet, ctx_d))
        if _fa().launches - fa_launches != 5:
            fail("the small-input UNet call did not take the kernel 5 times")
        vae_cpu = cpu_copy(pipe.vae)
        img_cpu = vae_cpu.decode(z)
        del vae_cpu
        img_gpu = pipe.vae.decode(z.cuda())
    for name, a, b in (("clip", ctx_gpu, ctx_cpu), ("unet eps", eps_gpu, eps_cpu),
                       ("vae decode", img_gpu, img_cpu)):
        e = rel_err(a, b)
        say(f"[reference] {name}: bf16 card vs fp32 cpu relative L2 error {e:.3e} "
            f"(tol {REFERENCE_TOL[name]})")
        if not torch.isfinite(a).all() or not e <= REFERENCE_TOL[name]:
            fail(f"{name} on the card disagrees with the CPU reference ({e:.3e})")


def _fa():
    from adaface_tpu_torch.ops import flash_attention
    return flash_attention


def phase_main_path(torch, pipe, card):
    fa = _fa()
    finite = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
             for m in (pipe.unet, pipe.vae.decoder, pipe.clip)]
    prompts = [PROMPT] * BATCH
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    t0 = time.time()
    pipe.generate(prompts, seed=0, **kw)
    say(f"[main] warm-up request {time.time() - t0:.3f} s [{card}]")
    times = []
    for i in range(3):
        fa.launches = 0
        fa.launches_by_shape.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        imgs = pipe.generate(prompts, seed=i + 1, **kw)
        times.append(time.time() - t0)
        counts = {(b, lq, h, d): n for (b, lq, lk, h, d), n in fa.launches_by_shape.items()}
        launches = fa.launches
        say(f"[main] request {i}: {times[-1]:.3f} s, {BATCH / times[-1]:.4f} img/s, "
            f"kernel launches {launches} {sorted(counts.items())} [{card}]")
        if launches != 750 or counts != {s: n for s, (_, n) in MAIN_SHAPES.items()}:
            fail(f"expected 750 launches ({MAIN_SHAPES}), got {launches} {counts}")
        if imgs.shape != (BATCH, SIZE, SIZE, 3) or str(imgs.dtype) != "uint8":
            fail(f"images {imgs.shape} {imgs.dtype}")
        if imgs.std() < 1.0 or imgs.reshape(BATCH, -1).std(axis=1).min() < 1.0:
            fail("constant images")
    for h in hooks:
        h.remove()
    if not bool(torch.stack(finite).all()):
        fail("NaN or Inf in a CLIP, UNet or VAE output during the main path")
    say(f"[main] {len(finite)} model outputs finite; images uint8 {imgs.shape}, "
        f"mean {imgs.mean():.2f} std {imgs.std():.2f}")
    med = statistics.median(times)
    say(f"[main] batch {BATCH} 512x512 DDIM-{STEPS} CFG 10->4 bf16: median "
        f"{med:.3f} s/request, {BATCH / med:.4f} img/s, best {min(times):.3f} s "
        f"[{card}]")
    return counts


def _category(name):
    if "flash_fwd_packed" in name:
        return "flash_attn_packed (this port's kernel)"
    if "fprop" in name or "conv" in name.lower() or "dgrad" in name:
        return "convolutions (cuDNN)"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "matrix products (cuBLAS)"
    if "at::native" in name:
        return "elementwise, reductions, norms (PyTorch)"
    return "other"


def phase_profile(torch, pipe, card):
    """Stage times, then one whole request under torch.profiler: device
    kernel time by category and the device's idle share of the request."""
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.models.unet import precompute_cross_kv

    prompts = [PROMPT] * BATCH
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((BATCH, SIZE // 8, SIZE // 8, 4), generator=gen, device="cuda")
    t = torch.full((BATCH,), 501, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        encode = lambda: (pipe.encode_prompts(prompts), pipe.encode_negative("", BATCH))
        ctx = pipe.encode_prompts(prompts)
        ctx = torch.cat([ctx, pipe.encode_negative("", BATCH).expand_as(ctx)], dim=1)
        kv = precompute_cross_kv(pipe.unet, ctx)
        unet_ms = time_ms(torch, lambda: pipe.unet(x, t, ctx, cfg_dedup=True, cross_kv=kv),
                          reps=5, rounds=3)
        encode_ms = time_ms(torch, encode, reps=5, rounds=3)
        vae_ms = time_ms(torch, lambda: pipe.vae.decode(x), reps=3, rounds=3)
    say(f"[profile] stages (CUDA events, mean of back-to-back calls): text encode {encode_ms:.3f} ms, "
        f"one UNet call (B{2 * BATCH} 64x64) {unet_ms:.3f} ms, VAE decode (B{BATCH}) "
        f"{vae_ms:.3f} ms [{card}]")
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.generate(prompts, seed=4, **kw)
        wall_ms = (time.time() - t0) * 1e3
    dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    kernels = [e for e in prof.key_averages() if dev(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_ms = sum(dev(e) for e in kernels) / 1e3
    if total_ms == 0:
        say("[profile] the profiler reported no device time: breakdown not measured")
        return
    say(f"[profile] one request under the profiler: wall {wall_ms:.1f} ms, device "
        f"kernel time {total_ms:.1f} ms, device idle share {1 - total_ms / wall_ms:.3f} "
        f"[{card}]")
    by_cat = {}
    for e in kernels:
        c = by_cat.setdefault(_category(e.key), [0.0, 0])
        c[0] += dev(e) / 1e3
        c[1] += e.count
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        say(f"[profile]   {ms:9.1f} ms {100 * ms / total_ms:5.1f}% {n:7d} launches  {cat}")
    for e in sorted(kernels, key=dev, reverse=True)[:10]:
        say(f"[profile]   top {dev(e) / 1e3:9.1f} ms x{e.count:<6d} {e.key[:100]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible to torch")
    try:
        from adaface_tpu_torch import kernels
        from adaface_tpu_torch.data.tokenizer import HashTokenizer
        from adaface_tpu_torch.pipeline import StableDiffusionPipeline
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    fa = _fa()

    card, exp2_rate = phase_card(torch)
    phase_build(kernels)
    rows = phase_kernels(torch, fa, card, exp2_rate)

    t0 = time.time()
    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(0, tok, dtype=torch.bfloat16, device="cuda")
    tid = tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=9, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    n_params = sum(p.numel() for m in (pipe.clip, pipe.unet, pipe.vae) for p in m.parameters())
    say(f"[main] SD-v1.5-width pipeline ({n_params / 1e6:.1f} M parameters, bf16) built "
        f"in {time.time() - t0:.1f} s")

    phase_reference(torch, pipe)
    counts = phase_main_path(torch, pipe, card)
    phase_profile(torch, pipe, card)

    entries = []
    for (b, l, h, d), (replaces, _) in MAIN_SHAPES.items():
        entries.append(dict(name=f"flash_attn_packed B{b} L{l} H{h} d{d}", route="cuda",
                            source=SOURCE, replaces=replaces, launches=counts[(b, l, h, d)],
                            **rows[(b, l, h, d)]))
    say(json.dumps({"kernels": entries}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
