"""YAML config trees with target/params instantiation and dotlist overrides
(counterpart of `adaface_tpu/config.py`): `load_config` deep-merges files
left to right, `apply_dotlist` applies `a.b.c=value` overrides with the
values YAML-parsed, `instantiate_from_config` builds `{'target': 'pkg.Cls',
'params': {...}}`. YAML is read by the port's own strict reader
(`_yaml.py`), which resolves scalars as `yaml.safe_load` does; pyyaml is not
needed.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Sequence

from adaface_tpu_torch import _yaml


def load_config(*paths: str) -> Dict:
    """Load and deep-merge YAML files left to right (later wins)."""
    cfg: Dict = {}
    for p in paths:
        with open(p) as f:
            cfg = merge_dicts(cfg, _yaml.safe_load(f.read()) or {})
    return cfg


def merge_dicts(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def apply_dotlist(cfg: Dict, dotlist: Sequence[str]) -> Dict:
    """Apply `a.b.c=value` overrides in place (values YAML-parsed: `1e-1`
    stays the string '1e-1', as in YAML 1.1)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, raw = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _yaml.safe_load(raw)
    return cfg


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: Dict, **extra) -> Any:
    """`{'target': 'pkg.mod.Cls', 'params': {...}}` -> instance."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params") or {})
    params.update(extra)
    return get_obj_from_str(config["target"])(**params)
