"""`use_remat` on the compos step and under the fused knobs, fp32 on the
CPU (the recon step's gradients are in `test_torch_trainer_state.py`,
whose helpers this file shares):

- the compos `loss_fn` gradients with every non-capturing
  SpatialTransformer rematerialized equal the un-rematerialized port's (to
  1e-6 of each leaf's largest entry) and JAX's with `use_remat` (at the
  compos slice's 1e-4); the capture layers (7 and 8 of the tiny UNet) are
  never checkpointed;
- under `ADAFACE_FUSED_FF=1` the recompute calls the fused feed-forward
  (K9) of each non-capturing block a second time, and the GroupNorm+SiLU
  (K8, in the ResBlocks, which are not rematerialized) no more often: the
  launches that a card run counts."""

import numpy as np
import pytest
import torch

from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import fused_ff
from adaface_tpu_torch.training import train_step as tts

from test_torch_compos import STEP_KW as COMPOS_KW
from test_torch_compos import _compos_batch, _jax_compos_value_and_grad
from test_torch_train_step import (  # noqa: F401
    STEP_KW,
    _assert_grads_close,
    _batch,
    _port_embedders,
    pipes,
)
from test_torch_trainer_state import (
    _jax_with_remat,
    _leaf_grads,
    _remat,
    _same_grads,
    _spy_checkpoint,
)

torch.set_num_threads(2)


def test_remat_compos_gradients(monkeypatch, pipes):
    jp, tp = pipes
    jb, tb = _compos_batch(jp, np.random.default_rng(24))
    empty = tp.encode_negative("", 1)[0, 0].clone()
    step = tts.make_compos_distill_step(tp.clip, tp.unet, tp.base_sched, None, empty_ctx=empty,
                                        **COMPOS_KW)
    emb = _port_embedders(tp)
    plain_loss, _ = step.loss_fn(emb, tb)
    plain_loss.backward()
    plain = _leaf_grads(emb)
    seen = _spy_checkpoint(monkeypatch, tp)
    with _remat(tp.unet):
        emb = _port_embedders(tp)
        loss, _ = step.loss_fn(emb, tb)
        loss.backward()
    assert seen and not {"up_0_attn_0", "up_0_attn_1"} & set(seen)
    assert loss.item() == pytest.approx(plain_loss.item(), rel=1e-6)
    _same_grads(_leaf_grads(emb), plain)
    (jloss, _), jgrads = _jax_compos_value_and_grad(_jax_with_remat(jp), COMPOS_KW, True)(
        jp.embedding_manager.embedders, jb)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads_close(emb, jgrads, tol=1e-4)


def test_remat_recomputes_the_fused_feed_forward(monkeypatch, pipes):
    jp, tp = pipes
    monkeypatch.setenv("ADAFACE_FUSED_FF", "1")
    monkeypatch.setenv("ADAFACE_GN_MAX_ELEMS", "4194304")
    calls = {"ff": 0, "gn": 0}
    real_ff, real_gn = fused_ff.ln_geglu_ff, tunet.group_norm_silu

    def ff(*a, **k):
        calls["ff"] += 1
        return real_ff(*a, **k)

    def gn(*a, **k):
        calls["gn"] += 1
        return real_gn(*a, **k)

    monkeypatch.setattr(fused_ff, "ln_geglu_ff", ff)
    monkeypatch.setattr(tunet, "group_norm_silu", gn)
    _, tb = _batch(jp, np.random.default_rng(6), [300, 700])
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, None, **STEP_KW)
    counts = {}
    for remat in (False, True):
        with _remat(tp.unet, remat):
            calls.update(ff=0, gn=0)
            loss, _ = step.loss_fn(_port_embedders(tp), tb)
            loss.backward()
            counts[remat] = dict(calls)
    blocks = [n for n, _ in tp.unet.named_children() if "attn" in n]
    uncaptured = len(blocks) - 2  # layers 7 and 8 capture (einsum path, unfused)
    assert counts[False]["ff"] == uncaptured
    assert counts[True]["ff"] == 2 * uncaptured
    assert counts[True]["gn"] == counts[False]["gn"] > 0
