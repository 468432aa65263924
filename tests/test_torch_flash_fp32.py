"""The fp32 route of the flash attention, on the CPU (the fp32 kernel
`csrc/flash_attn_fp32.cu` runs only on the card; `chip_smoke.py` phase 4g
holds it against its plain version there):

- an fp32 pipeline on the CPU gives the same images as before the fp32
  kernel existed: every packed attention call takes the plain version with
  fp32 tensors (spies), no CUDA wrapper is reached, the images equal those
  of the plain version called directly bit for bit, and JAX's within one
  uint8 level;
- the ctypes signatures of every flash C entry, the fp32 ones included,
  match the declarations in the `.cu` sources;
- the wrappers' operand checks: fp32 operands need only a unit column
  stride (the fp32 kernels read by element), bf16 ones keep their
  alignment rules."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from adaface_tpu_torch.ops import flash_attention as tfa

from test_torch_pipeline import PROMPTS, _pipelines

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(__file__), "..", "adaface_tpu_torch", "csrc")


def test_fp32_pipeline_images_unchanged_on_the_cpu(monkeypatch):
    jp, tp = _pipelines()
    x_T = np.random.default_rng(0).standard_normal((3, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, guidance_scale=(10.0, 4.0), height=32, width=32, x_T=x_T,
              negative_prompt="ugly, blurry")
    calls = []
    real_plain = tfa.flash_attention_blc_plain

    def plain_spy(q, *a, **k):
        calls.append(q.dtype)
        return real_plain(q, *a, **k)

    def no_card(*a, **k):
        raise AssertionError("a CUDA wrapper was reached with CPU tensors")

    monkeypatch.setattr(tfa, "flash_attention_blc_plain", plain_spy)
    for name in ("flash_attention_blc_cuda", "flash_backward_cuda", "flash_bwd_dq_cuda",
                 "flash_bwd_dkv_cuda"):
        monkeypatch.setattr(tfa, name, no_card)
    got = tp.generate(PROMPTS, **kw)
    assert calls and set(calls) == {torch.float32}
    # the CPU path as it was: the packed entry calls the plain version directly
    monkeypatch.setattr(tfa, "_flash", lambda q, k, v, bias, h, scale, arm, flags:
                        real_plain(q, k, v, h, bias, scale, flags).to(q.dtype))
    before = tp.generate(PROMPTS, **kw)
    np.testing.assert_array_equal(got, before)
    ref = jp.generate(PROMPTS, **kw)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "const long long*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(tfa.C_ENTRIES))
def test_c_signatures_match_the_sources(name):
    lib, argtypes = tfa.C_ENTRIES[name]
    src = open(os.path.join(CSRC, f"{lib}.cu")).read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"{name} is not declared in {lib}.cu"
    params = [re.sub(r"\s+", " ", p).strip() for p in m.group(1).split(",")]
    types = [re.match(r"(const long long\*|const void\*|void\*|int|float) ", p).group(1)
             for p in params]
    assert [_CTYPE[t] for t in types] == argtypes


def test_operand_checks_by_dtype():
    base = torch.zeros(2, 64, 3 * 40 + 1)
    view = base[:, :, 1:41]  # row stride 121, start off a 16-byte boundary
    tfa._check_operand(view, "q", view.device, 2, 40, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        tfa._check_operand(base.bfloat16()[:, :, 1:41], "q", view.device, 2, 40,
                           torch.bfloat16)
    with pytest.raises(TypeError):
        tfa._check_operand(view, "k", view.device, 2, 40, torch.bfloat16)
    with pytest.raises(ValueError, match="unit column stride"):
        tfa._check_operand(torch.zeros(2, 40, 64).transpose(1, 2), "v", view.device, 2, 40,
                           torch.float32)
