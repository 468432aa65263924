"""Writers of reference-format checkpoints for the port's CPU tests of the
serving surface (not a test module).

- `save_ldm_checkpoint`: an SD v1.x checkpoint in LDM names, as a torch zip
  `.ckpt` (`{"state_dict", "global_step", "callbacks"}`, the callbacks an
  object of a class no loader knows, whose unpickling would call
  `_must_not_run`) or a `.safetensors`.
- `save_reference_embeddings`: a reference `embeddings_gs-*.pt`, its static
  embedders and subject-basis generators pickled as live modules of
  stand-in classes registered, while the file is written, under the
  reference's module names (`ldm.modules.embedding_manager`,
  `ldm.modules.subj_basis_generator`); the reference tree itself is absent.
"""

from __future__ import annotations

import contextlib
import sys
import types
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

RAN = []  # appended to by `_must_not_run`: the loaders must leave it empty


def _must_not_run(*args):
    RAN.append(args)
    return {}


class LightningCallbackState:
    """A pickled object of a class the loaders have never seen, whose
    unpickling would run `_must_not_run`."""

    def __reduce__(self):
        return (_must_not_run, ("callback",))


def save_ldm_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                        dtype: Optional[torch.dtype] = None):
    """`state_dict` (cast to `dtype` when given) as a `.ckpt` torch zip or,
    by the file's suffix, a `.safetensors`."""
    from adaface_tpu_torch.interop.checkpoint_io import save_safetensors

    sd = {k: (v.to(dtype) if dtype is not None else v).detach().cpu().contiguous()
          for k, v in state_dict.items()}
    if path.endswith(".safetensors"):
        save_safetensors(sd, path)
    else:
        torch.save({"state_dict": sd, "global_step": 7,
                    "callbacks": {"ModelCheckpoint": LightningCallbackState()}}, path)


class StaticLayerwiseEmbedding(nn.Module):
    pass


class SubjBasisGenerator(nn.Module):
    pass


class CLIPTextConfigStandIn:
    """The HF config object a reference generator's text encoder carries."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


_STANDINS = {"ldm.modules.embedding_manager": [StaticLayerwiseEmbedding],
             "ldm.modules.subj_basis_generator": [SubjBasisGenerator, CLIPTextConfigStandIn]}


@contextlib.contextmanager
def reference_modules():
    """The stand-in classes importable under the reference's module names,
    for as long as the context lasts (earlier entries restored after)."""
    names = ["ldm", "ldm.modules"] + list(_STANDINS)
    saved = {n: sys.modules.get(n) for n in names}
    try:
        for n in names:
            sys.modules[n] = types.ModuleType(n)
        for mod, classes in _STANDINS.items():
            for cls in classes:
                cls.__module__ = mod
                setattr(sys.modules[mod], cls.__name__, cls)
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        for mod, classes in _STANDINS.items():
            for cls in classes:
                cls.__module__ = __name__


def module_from_flat(cls, flat: Dict[str, torch.Tensor], **attrs) -> nn.Module:
    """An instance of `cls` holding `flat`'s tensors as parameters at their
    dotted names (plain `nn.Module` children in between), with `attrs` set
    on it."""
    root = cls()
    for name, t in flat.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, nn.Parameter(torch.as_tensor(np.asarray(t)).clone(),
                                                  requires_grad=False))
    for k, v in attrs.items():
        setattr(root, k, v)
    return root


def save_reference_embeddings(path: str, statics: Dict[str, Dict[str, np.ndarray]],
                              generators: Optional[Dict[str, nn.Module]] = None,
                              token2num: Optional[Dict[str, int]] = None,
                              background: tuple = (), conv_ks=None,
                              scores: Optional[Dict[str, float]] = None):
    """A reference-format `.pt`: `statics` placeholder -> embedder fields
    (None fields left out), `generators` placeholder -> a stand-in module
    (`module_from_flat(SubjBasisGenerator, ...)`)."""
    names = list(statics) + [g for g in (generators or {}) if g not in statics]
    with reference_modules():
        ckpt = {
            "string_to_token": {s: torch.tensor(49408 + i) for i, s in enumerate(names)},
            "string_to_token_dict": {s: torch.tensor(49408 + i) for i, s in enumerate(names)},
            "string_to_static_embedder": nn.ModuleDict({
                s: module_from_flat(StaticLayerwiseEmbedding,
                                    {k: v for k, v in f.items() if v is not None})
                for s, f in statics.items()}),
            "string_to_subj_basis_generator_dict": nn.ModuleDict(generators or {}),
            "token2num_vectors": dict(token2num or {}),
            "emb_global_scale_scores": torch.tensor(
                [float((scores or {}).get(s, 0.0)) for s in names]),
            "use_conv_attn_kernel_size": conv_ks,
            "placeholder_strings": names,
            "subject_strings": [s for s in names if s not in background],
            "background_strings": list(background),
            "do_zero_shot": bool(generators),
        }
        torch.save(ckpt, path)
