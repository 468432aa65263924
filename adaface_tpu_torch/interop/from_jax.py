"""Weight bridge from the JAX package's flax param trees to the port.

The trees arrive as nested dicts of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, pipe.unet_params)`); the port's modules
carry the flax names, so the map is mechanical:

- Conv `kernel` HWIO -> `weight` OIHW;  Dense `kernel` [in, out] -> `weight` [out, in];
- LayerNorm `scale` and Embed `embedding` -> `weight`;
- every other leaf (biases, the bare GroupNorm `*_scale`/`*_bias`, the
  vision tower's `class_embedding`, a generator's `[1, N, D]` `pos_embs` and
  `latent_queries` and its `hidden_state_layer_weights`) as is.

Each `*_state_dict_from_jax` returns what `load_state_dict(strict=True)` takes.
The face detectors and the parser (`scrfd_state_dict_from_jax`,
`bisenet_state_dict_from_jax`: the plain map; `retinaface_state_dict_from_jax`
also moves flax's `batch_stats` into BatchNorm2d's running statistics).
`load_subj_basis_generator_from_jax` loads a zero-shot generator, whose flax
tree holds only the branches its init ran. `iresnet_state_dict_from_jax`
carries a JAX `IResNet` tree, whose fc takes NHWC-flattened features, to the
port's recognizer, which flattens NCHW. `jax_tree_from_module` is the
inverse, for round-trip checks.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.personalization.static_embedding import StaticEmbedderParams
from adaface_tpu_torch.personalization.subj_basis_generator import OBJECT_BRANCH


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, leaf in _leaves(tree):
        a = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            name = "weight"
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        elif name in ("scale", "embedding"):
            name = "weight"
        sd[".".join(path[:-1] + (name,))] = torch.tensor(np.ascontiguousarray(a))
    return sd


# the SD text encoder, the Arc2Face encoder (also a CLIP text tower), the
# UNet and the CLIP vision tower; SCRFD (its BN's `mean` / `var` are
# parameters, as in the recognizer) and BiSeNet (BN folded)
clip_state_dict_from_jax = unet_state_dict_from_jax = state_dict_from_jax
vision_state_dict_from_jax = state_dict_from_jax
scrfd_state_dict_from_jax = bisenet_state_dict_from_jax = state_dict_from_jax


def retinaface_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `RetinaFace`'s {"params", "batch_stats"} -> the port's state
    dict: the params as `state_dict_from_jax` maps them (a depthwise HWIO
    [3, 3, 1, C] kernel becomes [C, 1, 3, 3]), each BatchNorm's `mean` /
    `var` as `running_mean` / `running_var`, `num_batches_tracked` 0."""
    sd = state_dict_from_jax(variables["params"])
    for path, leaf in _leaves(variables["batch_stats"]):
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        prefix = ".".join(path[:-1])
        sd[f"{prefix}.{name}"] = torch.tensor(np.asarray(leaf))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def load_subj_basis_generator_from_jax(gen: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX `SubjBasisGenerator` param tree into the port's `gen`.
    Every leaf of the tree must land; of the module's own parameters only
    the fg object branch may be missing from the tree (it then keeps its
    values)."""
    missing, unexpected = gen.load_state_dict(state_dict_from_jax(tree), strict=False)
    # the object branch is absent from a tree initialized through the face
    # branch (flax makes a submodule's params when it first runs)
    missing = [k for k in missing if not k.startswith(OBJECT_BRANCH)]
    if missing or unexpected:
        raise ValueError(f"generator tree mismatch: missing {missing}, "
                         f"unexpected {unexpected}")
    return gen


def iresnet_state_dict_from_jax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A JAX `IResNet` tree -> the port's `IResNet` state dict. The JAX
    fc kernel's rows follow the H, W, C flatten of its NHWC features; the
    port's fc takes C, H, W, so the rows are permuted: both packages then
    compute the same embedding from the same params. (BatchNorm `scale` ->
    `weight`; `mean`, `var` and PReLU `alpha` as they are.)"""
    sd = state_dict_from_jax(tree)
    w = sd["fc.weight"]
    g, c = cfg.grid, cfg.channels[-1]
    sd["fc.weight"] = w.reshape(w.shape[0], g, g, c).permute(0, 3, 1, 2).reshape(
        w.shape[0], -1).contiguous()
    return sd


def vae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The whole AutoencoderKL tree: `encoder`, `quant_conv`, `decoder` and
    `post_quant_conv`."""
    return state_dict_from_jax(
        {k: params[k] for k in ("encoder", "quant_conv", "decoder", "post_quant_conv")})


def static_embedder_from_jax(p: Any) -> StaticEmbedderParams:
    """A JAX StaticEmbedderParams (or a dict of its fields) -> the port's."""
    get = (lambda n: p.get(n)) if isinstance(p, Mapping) else (lambda n: getattr(p, n))
    conv = lambda n: None if get(n) is None else torch.from_numpy(np.array(get(n)))
    return StaticEmbedderParams(
        basis_rand_weights=conv("basis_rand_weights"),
        basis_comm_weights=conv("basis_comm_weights"),
        basis_vecs=conv("basis_vecs"), pre_vecs=conv("pre_vecs"), bias=conv("bias"))


def jax_tree_from_module(module: nn.Module) -> Dict[str, Any]:
    """The flax-layout tree of numpy arrays for a port module."""
    tree: Dict[str, Any] = {}
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            a = p.detach().cpu().numpy()
            if name == "weight" and isinstance(mod, nn.Conv2d):
                name, a = "kernel", a.transpose(2, 3, 1, 0)
            elif name == "weight" and isinstance(mod, nn.Linear):
                name, a = "kernel", a.T
            elif name == "weight" and isinstance(mod, nn.LayerNorm):
                name = "scale"
            elif name == "weight" and isinstance(mod, nn.Embedding):
                name = "embedding"
            node = tree
            for part in mod_name.split(".") if mod_name else ():
                node = node.setdefault(part, {})
            node[name] = np.ascontiguousarray(a)
    return tree
