"""The port's config loading against the JAX package's, on the CPU: the
port's strict YAML reader (`adaface_tpu_torch/_yaml.py`) against
`yaml.safe_load` (YAML 1.1, pyyaml) on every file of `configs/` and on a
battery of scalar spellings (fixed probes and generated ones), the refusals
of what lies outside the subset, and `load_config` / `apply_dotlist`
against `adaface_tpu.config`'s. Exact equality, types included."""

import glob
import math
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from adaface_tpu import config as jconfig

from adaface_tpu_torch import _yaml
from adaface_tpu_torch import config as tconfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))

# YAML 1.1 scalar spellings that a reader gets wrong easily, and their neighbours
PROBES = ["1e-4", "1.0e4", "1.0e+4", "1.0e-06", "2.0e-4", ".5", "-.5", "+.5", "1.",
          "1_000", "1__0", "_1", "0x10", "-0x1F", "0b101", "010", "08", "00", "0", "-0",
          "07.5", "0o7", "1:30", "-1:30", "1.5:30", "190:20:30.15", "-1", "+1",
          "yes", "Yes", "YES", "no", "on", "On", "off", "OFF", "true", "False", "y", "n",
          "~", "null", "Null", "NULL", "nul", "", "  ", ".inf", "-.Inf", "+.INF", ".nan",
          ".NaN", "inf", "nan", "a b", "foo bar baz", "x # comment", "x#y", "'a # b'",
          "'it''s'", '"tab\\there"', '"\\u00e9\\x41"', "''", '""', "[]", "[ ]",
          "[0.7, 1.0]", "[2, 2]", "[1, [2, 3], 'x', yes, ~]", "[1,2,]", "[a b, c]",
          "hello: world", "a: [1, 2]", "bfloat16", "adaface_tpu.pipeline.X", "-x",
          "1e3", "1E+3", "1.0E+3", "6.02e23"]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load_on_every_config(path):
    text = open(path).read()
    assert _same(_yaml.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", PROBES)
def test_scalar_spellings_resolve_as_safe_load(text):
    assert _same(_yaml.safe_load(text), yaml.safe_load(text)), text
    # the same spelling as a mapping value (where pyyaml refuses it, so does
    # the port)
    doc = f"trainer:\n  key: {text}\n"
    try:
        want = yaml.safe_load(doc)
    except yaml.YAMLError:
        with pytest.raises(_yaml.YamlError):
            _yaml.safe_load(doc)
        return
    assert _same(_yaml.safe_load(doc), want), doc


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="0123456789_.:+-eExXbBoO aAfFnNyYtTlLsu~", min_size=1,
               max_size=10))
def test_generated_scalars_resolve_as_safe_load(text):
    try:
        want = yaml.safe_load(f"k: {text}")
    except yaml.YAMLError:
        return  # pyyaml refuses it: nothing to compare
    if not isinstance(want, dict) or set(want) != {"k"}:
        return
    try:
        got = _yaml.safe_load(f"k: {text}")
    except _yaml.YamlError:
        # the port refuses only what lies outside its subset (timestamps,
        # mappings inside values, block sequences, ...): never a value
        # pyyaml reads as an int, float, bool or None
        assert not isinstance(want["k"], (int, float, bool, type(None))), text
        return
    assert _same(got, want), text


UNSUPPORTED = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!int 1\n",
    "block scalar": "a: |\n  text\n",
    "folded scalar": "a: >\n  text\n",
    "multi-document": "a: 1\n---\nb: 2\n",
    "document start": "---\na: 1\n",
    "flow mapping": "a: {b: 1}\n",
    "flow mapping in a list": "a: [{b: 1}]\n",
    "tab indentation": "a:\n\tb: 1\n",
    "tab in a value": "a: 1\t# c\n",
    "block sequence": "a:\n  - 1\n  - 2\n",
    "top-level sequence": "- 1\n- 2\n",
    "timestamp": "a: 2001-12-14\n",
    "merge key": "<<: 1\n",
    "duplicate key": "a: 1\na: 2\n",
    "mapping in a value": "a: b: c\n",
    "directive": "%YAML 1.1\na: 1\n",
    "multi-line plain scalar": "a: one\n  two\n",
    "bad indentation": "a:\n    b: 1\n  c: 2\n",
    "unterminated list": "a: [1, 2\n",
    "unterminated quote": "a: 'x\n",
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_constructs_outside_the_subset_raise(name):
    with pytest.raises(_yaml.YamlError):
        _yaml.safe_load(UNSUPPORTED[name])


def test_load_config_merges_as_jax(tmp_path):
    over = tmp_path / "over.yaml"
    over.write_text("trainer:\n  max_steps: 7\n  learning_rate: 1e-4\nnew:\n  x: [1, 2]\n")
    paths = [os.path.join(ROOT, "configs", "finetune-ada.yaml"), str(over)]
    assert _same(tconfig.load_config(*paths), jconfig.load_config(*paths))
    for p in CONFIGS:
        assert _same(tconfig.load_config(p), jconfig.load_config(p))


@pytest.mark.parametrize("dotlist", [
    ["trainer.grad_clip=1e-1"], ["trainer.learning_rate=4.0e-3", "data.size=256"],
    ["model_options.use_remat=true"], ["iter_plan.composition_regs_iter_gap=0x10"],
    ["data.scale_range=[0.5, 1.0]", "a.b.c=yes", "x=", "y=~", "z='1e-4'"],
])
def test_apply_dotlist_as_jax(dotlist):
    base = os.path.join(ROOT, "configs", "finetune-static-layerwise.yaml")
    got = tconfig.apply_dotlist(tconfig.load_config(base), dotlist)
    want = jconfig.apply_dotlist(jconfig.load_config(base), dotlist)
    assert _same(got, want)
    with pytest.raises(ValueError):
        tconfig.apply_dotlist({}, ["no_equals_sign"])


def test_instantiate_from_config():
    obj = tconfig.instantiate_from_config(
        {"target": "adaface_tpu_torch.training.iter_plan.IterPlanConfig",
         "params": {"composition_regs_iter_gap": 5}}, max_steps=9)
    assert (obj.composition_regs_iter_gap, obj.max_steps) == (5, 9)
    with pytest.raises(KeyError):
        tconfig.instantiate_from_config({"params": {}})
