"""The fp32 instances of K8, K9 and K10 (`csrc/gn_silu.cu`'s fp32 instance,
`csrc/ln_geglu_ff_fp32.cu`, `csrc/winograd_fp32.cu`) on the CPU. The
kernels run only on the card: `chip_smoke.py` holds them against their
plain versions there (phase 4h) and drives them through fp32 training
(9e) and fp32 requests ([fp32-main]). Here:

- every C entry of the three wrappers' modules matches its declaration in
  its `.cu` source;
- the wrappers' checks by dtype: bf16 and fp32 pass the dtype check and a
  CPU tensor then raises (no wrapper falls back to a plain version), any
  other dtype raises TypeError; fp32 scale, bias, weights and vectors
  reach the kernel in fp32, not rounded to bf16;
- K8's launch plan with 4-byte elements: every row of an image in exactly
  one CTA of its cluster, and the cluster rule at the fp32 byte budget;
- the fp32 fused UNet's compos loss and every embedder gradient against
  JAX's `value_and_grad` under the same knobs (Pallas in interpret mode),
  beside the recon case of `test_torch_fused_unet.py`;
- an fp32 `Trainer` under the fused knobs draws the same batches as
  without them and logs the same metrics (gap 3: compos and recon
  micro-steps).

Tolerances: the compos metrics 1e-5 relative and the gradients 2e-4 of
each leaf's largest entry, as `test_torch_fused_unet.py` and
`test_torch_compos.py` (fp32 sums in other orders in XLA and torch);
fused against unfused in the port, metrics and x_start latents 1e-5
relative (the kernels' plain versions round the statistics and the GEGLU
chain at other places than the unfused ops)."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.ops import fused_ff as tff
from adaface_tpu_torch.ops import fused_norm as tfn
from adaface_tpu_torch.ops import winograd as tw
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_torch_compos import STEP_KW as COMPOS_KW
from test_torch_compos import _compos_batch, _jax_compos_value_and_grad
from test_torch_fused_unet import GN_MAX, GN_SITES, fused, spy  # noqa: F401
from test_torch_train_step import (  # noqa: F401
    PLAN_KW,
    _assert_grads_close,
    _port_embedders,
    pipes,
    subject_dir,
)

torch.set_num_threads(2)

CSRC = Path(tfn.__file__).resolve().parent.parent / "csrc"
SMS = 132  # H100 SXM
RTOL = 1e-5
KNOBS = {"ADAFACE_GN_MAX_ELEMS": str(GN_MAX), "ADAFACE_FUSED_FF": "1"}

_CTYPE = {"const void*": "p", "void*": "p", "int": "i", "float": "f"}
ENTRIES = [(mod, name) for mod in (tfn, tff, tw) for name in sorted(mod.C_ENTRIES)]


@pytest.mark.parametrize("mod,name", ENTRIES, ids=[name for _, name in ENTRIES])
def test_c_signatures_match_the_sources(mod, name):
    lib, argtypes = mod.C_ENTRIES[name]
    src = (CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"{name} is not declared in {lib}.cu"
    params = [re.sub(r"\s+", " ", p).strip() for p in m.group(1).split(",")]
    types = [re.match(r"(const void\*|void\*|int|float) ", p).group(1) for p in params]
    want = {"p": mod._P, "i": mod._I, "f": getattr(mod, "_F", None)}
    assert [want[_CTYPE[t]] for t in types] == argtypes


def test_the_fp32_entries_exist():
    assert tfn.KERNEL_DTYPES[torch.float32] == ("gn_silu_fwd_fp32", "fp32")
    assert tfn.KERNEL_DTYPES[torch.bfloat16] == ("gn_silu_fwd", "bf16")
    assert tff.C_ENTRIES["ln_geglu_ff_fp32_fwd"][0] == "ln_geglu_ff_fp32"
    assert tw.C_ENTRIES["winograd_conv3x3_fp32_fwd"][0] == "winograd_fp32"


def _wrapper_calls(dtype):
    """Each CUDA wrapper called on CPU tensors of `dtype`."""
    x3 = torch.zeros((2, 8, 64), dtype=dtype)
    vec = lambda n: torch.zeros(n, dtype=dtype)
    w1, w2 = torch.zeros((64, 512), dtype=dtype), torch.zeros((256, 64), dtype=dtype)
    x4 = torch.zeros((1, 8, 8, 32), dtype=dtype)
    ut = torch.zeros((16, 64, 64), dtype=dtype)
    return {"gn": lambda: tfn.group_norm_silu_cuda(x3, vec(64), vec(64)),
            "ff": lambda: tff.ln_geglu_ff_cuda(x3, vec(64), vec(64), w1, vec(512), w2, vec(64)),
            "wino": lambda: tw.winograd_conv3x3_cuda(x4, ut, vec(32))}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("kernel", ["gn", "ff", "wino"])
def test_other_dtypes_raise(kernel, dtype):
    with pytest.raises(TypeError):
        _wrapper_calls(dtype)[kernel]()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["gn", "ff", "wino"])
def test_kernel_dtypes_pass_and_cpu_tensors_never_fall_back(kernel, dtype):
    """Past the dtype check a CPU tensor raises: the wrappers launch a
    kernel or raise, and never compute the plain version."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        _wrapper_calls(dtype)[kernel]()


def test_winograd_operands_share_x_dtype():
    x = torch.zeros((1, 8, 8, 32), dtype=torch.float32)
    with pytest.raises(TypeError, match="ut is torch.bfloat16"):
        tw.winograd_conv3x3_cuda(x, torch.zeros((16, 64, 64), dtype=torch.bfloat16),
                                 torch.zeros(32))


def test_fp32_vectors_stay_fp32():
    """K8's scale and bias as the fp32 instance reads them: an aligned
    contiguous fp32 vector is passed as it is; fp64 becomes fp32, not
    bf16."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(320).astype(np.float32))
    assert v.data_ptr() % 16 == 0
    assert tfn._as_vector(v, 320, "scale", v.device, torch.float32) is v
    got = tfn._as_vector(v.double() / 3, 320, "scale", v.device, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), (v.double() / 3).float().numpy())
    assert not torch.equal(got, got.bfloat16().float())
    assert tfn._as_vector(v, 320, "bias", v.device, torch.bfloat16).dtype == torch.bfloat16


def test_fp32_ff_operands_stay_fp32():
    """K9's operands: nn.Linear's weight, passed transposed as the UNet
    passes it, comes back as that fp32 weight bit for bit (no bf16
    rounding, no copy); the vectors stay fp32."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    w1 = w.t()  # [C, 2F], as ln_geglu_ff takes it
    got = tff._operand(w1.t(), (512, 64), "w1^T", w.device, torch.float32)
    assert got.dtype == torch.float32 and got.data_ptr() == w.data_ptr()
    np.testing.assert_array_equal(got.numpy(), w.numpy())
    b = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    assert torch.equal(tff._operand(b, (512,), "b1", b.device, torch.float32), b)
    assert tff._operand(w1.t(), (512, 64), "w1^T", w.device,
                        torch.bfloat16).dtype == torch.bfloat16


GN_SHAPES = sorted(set(chip_smoke.GN_SHAPES) | set(chip_smoke.GN_TRAIN_SHAPES)
                   | set(chip_smoke.GN_COMPOS_SHAPES))


@pytest.mark.parametrize("shape", GN_SHAPES + chip_smoke.GN_EDGE_SHAPES)
def test_fp32_plan_covers_every_row_once(shape):
    b, n, c = shape
    plan = tfn.launch_plan(b, n, c, SMS, 4)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= n
    owner = np.full(n, -1)
    for rank in range(plan.cluster):
        r0, r1 = tfn.cta_rows(n, plan.cluster, rank)
        assert 0 < r1 - r0 <= -(-n // plan.cluster)
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = rank
    assert (owner >= 0).all()
    assert plan.threads % (c // 8) == 0 and plan.threads >= 32
    assert plan.threads <= tfn.MAX_THREADS or plan.threads == c // 8 <= tfn.WIDE_THREADS


def test_fp32_plan_cluster_rule():
    """The smallest cluster whose grid fills the card while a CTA streams
    at most CTA_BYTES of 4-byte elements, else the largest: twice bf16's
    bytes, so a cluster at least bf16's, and larger where bf16's CTA
    streams more than half the budget (B16 N1024 C640: 8 -> 16)."""
    for b, n, c in GN_SHAPES + chip_smoke.GN_EDGE_SHAPES:
        plan = tfn.launch_plan(b, n, c, SMS, 4)
        sizes = [s for s in (1, 2, 4, 8, 16) if s <= n]
        ok = [s for s in sizes
              if b * s >= tfn.FILL * SMS and 4 * c * -(-n // s) <= tfn.CTA_BYTES]
        assert plan.cluster == (ok[0] if ok else sizes[-1])
        assert plan.cluster >= tfn.launch_plan(b, n, c, SMS).cluster
    assert tfn.launch_plan(16, 1024, 640, SMS).cluster == 8
    assert tfn.launch_plan(16, 1024, 640, SMS, 4).cluster == 16


def test_fused_fp32_compos_loss_and_grads_match_jax(fused, pipes, spy):
    """One compos loss (compel, fg-init, the bg token), its metrics and
    every embedder gradient with both knobs on, against JAX's under the
    same knobs. One UNet call of 4 rows: all 17 GroupNorm+SiLU sites fuse,
    and 5 of the 7 transformer blocks (layers 7 and 8 capture), each
    recomputed once by the backward."""
    jp, tp = pipes
    jb, tb = _compos_batch(jp, np.random.default_rng(23))
    (_, jmetrics), jgrads = _jax_compos_value_and_grad(jp, COMPOS_KW, True)(
        jp.embedding_manager.embedders, jb)
    step = tts.make_compos_distill_step(tp.clip, tp.unet, tp.base_sched, None,
                                        empty_ctx=tp.encode_negative("", 1)[0, 0].clone(),
                                        **COMPOS_KW)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, tb)
    loss.backward()
    assert spy == {"group_norm_silu_plain": GN_SITES, "ln_geglu_ff_plain": 2 * 5,
                   "ln_geglu_ff_unfused": 2}
    assert set(metrics) == set(jmetrics)
    for k in sorted(metrics):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads)


def _fit(tp, subject_dir, logdir):
    """A gap-3 fp32 fit(4) (compos 0 and 3, recon 1 and 2) from the shared
    embedders, restored after; returns (the batches it built, its step
    records)."""
    before = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
              for s, p in tp.embedding_manager.embedders.items()}
    tr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                 TrainerConfig(batch_size=2, max_steps=4, seed=1, log_every_steps=1000,
                               logdir=str(logdir)),
                 IterPlanConfig(**dict(PLAN_KW, composition_regs_iter_gap=3)))
    batches = []
    for kind in ("recon", "compos"):
        real = getattr(tr, f"build_{kind}_batch")
        setattr(tr, f"build_{kind}_batch",
                lambda plan, _r=real, _k=kind: batches.append((_k, _r(plan))) or batches[-1][1])
    try:
        tr.fit()
    finally:
        tr.close()
        with torch.no_grad():
            for s, p in tp.embedding_manager.embedders.items():
                for n, t in embedder_leaves(p):
                    t.requires_grad_(False)
                    t.copy_(before[s][n])
    recs = [json.loads(line) for line in open(Path(logdir) / "metrics.jsonl")]
    return batches, [r for r in recs if "loss" in r]


def _assert_batches_match(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=1e-6,
                                       err_msg=name)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        elif isinstance(x, dict):
            assert sorted(x) == sorted(y), name
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_fp32_trainer_under_the_fused_knobs_matches_without(pipes, subject_dir, tmp_path,
                                                            monkeypatch, spy):
    _, tp = pipes
    assert tp.unet.in_conv.weight.dtype == torch.float32
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    plain_batches, plain_recs = _fit(tp, subject_dir, tmp_path / "default")
    assert spy["group_norm_silu_plain"] == spy["ln_geglu_ff_plain"] == 0
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    fused_batches, fused_recs = _fit(tp, subject_dir, tmp_path / "fused")
    assert spy["group_norm_silu_plain"] > 0 and spy["ln_geglu_ff_plain"] > 0
    assert [k for k, _ in fused_batches] == [k for k, _ in plain_batches] == [
        "compos", "recon", "recon", "compos"]
    for (_, a), (_, b) in zip(fused_batches, plain_batches):
        _assert_batches_match(a, b)
    assert [r["iter_type"] for r in fused_recs] == [r["iter_type"] for r in plain_recs]
    for a, b in zip(fused_recs, plain_recs):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=RTOL, atol=1e-7, err_msg=k)
