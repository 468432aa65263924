"""Typed, persisted web-UI settings (counterpart of
`adaface_tpu/webui_params.py`): two dataclasses with the reference's
`DictI` / `DictT` field surface (`webuiParamClass.py:1-117`) and
load / save / update helpers, so that the app's settings survive a restart
(the reference round-trips `webui-setting-config.yaml`).

Files are read and written by the port's own YAML subset (`_yaml.py`): the
card's machine has no pyyaml. `save_settings` writes what pyyaml's
`safe_dump(data, sort_keys=True)` writes for the same settings, so either
package reads the other's file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from adaface_tpu_torch import _yaml

DEFAULT_SETTINGS_PATH = "webui-settings.yaml"


@dataclasses.dataclass
class InferenceSettings:
    """`DictI` (`webuiParamClass.py:5-40`) + the persisted extras in
    `webui-setting-config.yaml`. Fields with no counterpart in the port
    (CUDA `gpu` index, `laion400m`, `precision` autocast) are kept for
    round-trip fidelity but unused — the MIGRATION table dispositions them.
    """

    prompt: str = "a z in a garden"
    class_prompt: Optional[str] = None
    neg_prompt: str = ""
    outdir: str = "outputs"
    indiv_subdir: str = "samples"
    skip_grid: bool = False
    skip_save: bool = False
    ddim_steps: int = 20
    plms: bool = False
    fixed_code: bool = False
    ddim_eta: float = 0.0
    n_repeat: int = 1
    H: int = 512
    W: int = 512
    C: int = 4
    f: int = 8
    n_samples: int = 4
    bs: int = 8
    n_rows: int = 0
    scale: float = 10.0
    scale_min: float = 4.0  # annealed CFG floor (`--scale_min` here)
    from_file: str = ""
    config: str = "configs/v1-inference-ada.yaml"
    ckpt: str = ""
    seed: int = 42
    precision: str = "autocast"
    embedding_paths: Optional[List[str]] = None
    subj_scale: float = 1.0
    init_img: Optional[str] = None
    mask_weight: float = 0.0
    no_preview: bool = False
    broad_class: int = 1
    calc_face_sim: bool = False
    gpu: int = 0
    compare_with: Optional[str] = None
    clip_last_layers_skip_weights: List[float] = dataclasses.field(
        default_factory=lambda: [0.5, 0.5])
    debug: bool = False
    # webui-setting-config.yaml extras
    add_image_number: bool = False
    file_format: str = ""
    file_format_grid: str = ""
    image_file_pattern: str = ""
    ref_prompt: Optional[str] = None
    ref_prompt_mix_weight: float = 0.0
    scores_csv: Optional[str] = None
    # this app's own knobs (no reference field; persisted the same way)
    sampler: str = "ddim"
    compel: float = 0.0


@dataclasses.dataclass
class TrainSettings:
    """`DictT` (`webuiParamClass.py:62-90`)."""

    name: str = ""
    resume: str = ""
    base: List[str] = dataclasses.field(default_factory=list)
    train: bool = False
    no_test: bool = False
    project: str = ""
    debug: bool = False
    seed: int = 23
    postfix: str = ""
    logdir: str = "logs"
    lr: float = -1.0
    scale_lr: bool = True
    datadir_in_name: bool = False
    data_roots: str = ""
    actual_resume: str = ""  # the reference's (sic) `actural_resume`
    embedding_manager_ckpt: str = ""
    subject_string: str = ""
    cls_delta_string: Optional[str] = None
    subj_init_word_weights: List[float] = dataclasses.field(
        default_factory=lambda: [1.0])
    layerwise_lora_rank: int = 5
    embedding_reg_weight: float = -1.0
    composition_delta_reg_weight: float = -1.0
    min_rand_scaling: float = 0.8
    max_rand_scaling: float = 1.05
    num_compositions_per_image: int = 1
    broad_class: int = 1
    clip_last_layers_skip_weights: List[float] = dataclasses.field(
        default_factory=lambda: [0.5, 0.5])
    no_wandb: bool = True


def _coerce(cls_field: dataclasses.Field, value):
    """Best-effort cast of a YAML/form value to the field's declared type
    (the reference's DictX accepts anything; typed settings catch the
    'seed="abc"' class of UI bug at load time instead of mid-generate)."""
    if value is None:
        return None
    t = cls_field.type
    base = {"int": int, "float": float, "str": str, "bool": bool}
    for name, ctor in base.items():
        if t == name or t.startswith(f"{name}") or f"[{name}]" in t:
            if ctor is bool and isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            if t.startswith("List") or t.startswith("Optional[List"):
                seq = (value.split() if isinstance(value, str) else list(value))
                inner = float if "float" in t else str if "str" in t else int
                return [inner(v) for v in seq]
            return ctor(value)
    return value


def from_dict(cls, data: dict):
    """Build settings from a dict, coercing types and ignoring unknown keys
    (forward/backward compatible with older settings files)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in (data or {}).items():
        if k == "actural_resume":  # accept the reference's spelling
            k = "actual_resume"
        if k in fields:
            kw[k] = _coerce(fields[k], v)
    return cls(**kw)


def load_settings(path: str = DEFAULT_SETTINGS_PATH):
    """(InferenceSettings, TrainSettings) from a YAML file; defaults when
    the file is absent (first run)."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = _yaml.safe_load(f) or {}
    # flat files (like the reference's webui-setting-config.yaml) hold
    # inference keys at top level; sectioned files use inference:/train:
    inf = data.get("inference", data)
    tr = data.get("train", {}) if isinstance(data.get("train"), dict) else {}
    return from_dict(InferenceSettings, inf), from_dict(TrainSettings, tr)


def save_settings(inference: InferenceSettings,
                  train: Optional[TrainSettings] = None,
                  path: str = DEFAULT_SETTINGS_PATH) -> str:
    """Persist settings (the `app.py:51-56` write-back, but atomic and for
    every field, not just the seed)."""
    data = {"inference": dataclasses.asdict(inference)}
    if train is not None:
        data["train"] = dataclasses.asdict(train)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(_yaml.safe_dump(data))
    os.replace(tmp, path)
    return path


def update_settings(path: str = DEFAULT_SETTINGS_PATH, **changes):
    """Load → apply field changes → save; returns the new settings pair.

    Bare keys target `InferenceSettings` first (falling back to
    `TrainSettings` for train-only names); fields whose names exist on
    BOTH dataclasses (seed, debug, broad_class,
    clip_last_layers_skip_weights) must use a `train.`-prefixed key to
    reach the TrainSettings copy — e.g. ``update_settings(p,
    **{"train.seed": 7})``.
    """
    inf, tr = load_settings(path)
    fields = {f.name: f for f in dataclasses.fields(InferenceSettings)}
    tfields = {f.name: f for f in dataclasses.fields(TrainSettings)}
    for k, v in changes.items():
        if k.startswith("train."):
            k = k[len("train."):]
            if k in tfields:
                setattr(tr, k, _coerce(tfields[k], v))
        elif k in fields:
            setattr(inf, k, _coerce(fields[k], v))
        elif k in tfields:
            setattr(tr, k, _coerce(tfields[k], v))
    save_settings(inf, tr, path)
    return inf, tr
