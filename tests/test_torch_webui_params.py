"""The port's persisted web-UI settings (`adaface_tpu_torch/webui_params.py`)
and its YAML writer (`_yaml.safe_dump`) against the JAX package's, which
reads and writes through pyyaml (the card's machine has none):

- a file JAX's `save_settings` wrote loads in the port to equal settings, and
  the port's file is byte for byte JAX's (so `yaml.safe_load` reads it to the
  same dict), for the defaults and for settings that reach each trap;
- the reference's flat `webui-setting-config.yaml` and sectioned files;
  `update_settings`' `train.` prefix for the names both dataclasses hold;
- the writer's traps, each held against pyyaml's bytes and against the other
  choice: indentless block sequences, the 80-column fold of a long prompt,
  quoted number-like and bool-like strings, `1.0e-05` against `1e-05`; the
  reader on pyyaml's output (block sequences indented or not, folded plain
  and quoted scalars), with hypothesis over text and floats."""

import dataclasses
import math

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from adaface_tpu import webui_params as jwp

from adaface_tpu_torch import _yaml
from adaface_tpu_torch import webui_params as twp

LONG_PROMPT = ("a z person standing in a sunlit garden full of tall sunflowers, wearing a "
               "red scarf, highly detailed, soft light, 35mm photograph")


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _pairs():
    """(JAX, port) settings pairs: the defaults, and settings at the traps."""
    out = [((jwp.InferenceSettings(), jwp.TrainSettings()),
            (twp.InferenceSettings(), twp.TrainSettings()))]
    inf = dict(prompt=LONG_PROMPT, neg_prompt="yes", class_prompt="1.0", outdir="null",
               from_file="a: b", scale=7.5, scale_min=1e-05, seed=123456,
               embedding_paths=["logs/z/embeddings_gs-4500.pt", "0x10", "'quoted'"],
               clip_last_layers_skip_weights=[0.25, 1e-05], ref_prompt=" leading space",
               compare_with="it's #hash", sampler="plms", compel=2.0, H=768)
    tr = dict(base=["configs/finetune-ada.yaml"], lr=4e-3, seed=7, subject_string="on",
              subj_init_word_weights=[1.0, 0.5, float("inf")], cls_delta_string="~")
    out.append(((jwp.InferenceSettings(**inf), jwp.TrainSettings(**tr)),
                (twp.InferenceSettings(**inf), twp.TrainSettings(**tr))))
    return out


@pytest.mark.parametrize("case", [0, 1], ids=["defaults", "traps"])
def test_save_settings_writes_jax_bytes(tmp_path, case):
    (jinf, jtr), (tinf, ttr) = _pairs()[case]
    jpath, tpath = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    jwp.save_settings(jinf, jtr, jpath)
    twp.save_settings(tinf, ttr, tpath)
    jbytes, tbytes = open(jpath, "rb").read(), open(tpath, "rb").read()
    assert tbytes == jbytes
    assert _same(yaml.safe_load(tbytes), {"inference": dataclasses.asdict(jinf),
                                          "train": dataclasses.asdict(jtr)})
    assert not (tmp_path / "port.yaml.tmp").exists()


@pytest.mark.parametrize("case", [0, 1], ids=["defaults", "traps"])
def test_port_loads_jax_file_and_jax_loads_port_file(tmp_path, case):
    (jinf, jtr), (tinf, ttr) = _pairs()[case]
    jpath, tpath = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    jwp.save_settings(jinf, jtr, jpath)
    twp.save_settings(tinf, ttr, tpath)
    got_inf, got_tr = twp.load_settings(jpath)
    assert _same(dataclasses.asdict(got_inf), dataclasses.asdict(tinf))
    assert _same(dataclasses.asdict(got_tr), dataclasses.asdict(ttr))
    back_inf, back_tr = jwp.load_settings(tpath)
    assert _same(dataclasses.asdict(back_inf), dataclasses.asdict(jinf))
    assert _same(dataclasses.asdict(back_tr), dataclasses.asdict(jtr))


def test_field_surface_and_defaults_equal_jax():
    for jcls, tcls in ((jwp.InferenceSettings, twp.InferenceSettings),
                       (jwp.TrainSettings, twp.TrainSettings)):
        jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
        assert tf == jf
        assert _same(dataclasses.asdict(tcls()), dataclasses.asdict(jcls()))


REFERENCE_FLAT = """\
add_image_number: true
calc_face_sim: false
compare_with: null
entended_info: false
file_format: ''
file_format_grid: ''
from_file: ''
image_file_pattern: '[0-9]*.png'
init_img: null
ref_prompt: null
ref_prompt_mix_weight: 0.0
scores_csv: null
seed: 1234
skip_grid: false
skip_save: false
"""


def test_reference_flat_file_and_sectioned_file(tmp_path):
    flat = tmp_path / "webui-setting-config.yaml"
    flat.write_text(REFERENCE_FLAT)
    want = jwp.load_settings(str(flat))
    got = twp.load_settings(str(flat))
    assert got[0].seed == 1234 and got[0].image_file_pattern == "[0-9]*.png"
    for g, w in zip(got, want):
        assert _same(dataclasses.asdict(g), dataclasses.asdict(w))
    sectioned = tmp_path / "s.yaml"
    sectioned.write_text("inference:\n  seed: 5\n  plms: yes\n  bogus: 1\n"
                         "train:\n  seed: 9\n  actural_resume: sd.ckpt\n  base:\n"
                         "  - a.yaml\n  - b.yaml\n")
    got, want = twp.load_settings(str(sectioned)), jwp.load_settings(str(sectioned))
    for g, w in zip(got, want):
        assert _same(dataclasses.asdict(g), dataclasses.asdict(w))
    assert got[1].actual_resume == "sd.ckpt" and got[1].base == ["a.yaml", "b.yaml"]
    assert twp.load_settings(str(tmp_path / "absent.yaml"))[0] == twp.InferenceSettings()


def test_update_settings_train_prefix_as_jax(tmp_path):
    """The names both dataclasses hold reach TrainSettings only through
    `train.`; a bare one changes InferenceSettings."""
    jpath, tpath = str(tmp_path / "j.yaml"), str(tmp_path / "t.yaml")
    changes = [dict(seed=9, debug="true", broad_class=2, clip_last_layers_skip_weights="0.3 0.7",
                    logdir="logs/x", ddim_steps="30"),
               {"train.seed": 77, "train.debug": "yes", "train.broad_class": 0,
                "train.clip_last_layers_skip_weights": [0.1, 0.9], "train.bogus": 1}]
    for ch in changes:
        got = twp.update_settings(tpath, **ch)
        want = jwp.update_settings(jpath, **ch)
        for g, w in zip(got, want):
            assert _same(dataclasses.asdict(g), dataclasses.asdict(w))
    inf, tr = twp.load_settings(tpath)
    assert (inf.seed, inf.debug, inf.broad_class) == (9, True, 2)
    assert (tr.seed, tr.debug, tr.broad_class) == (77, True, 0)
    assert tr.clip_last_layers_skip_weights == [0.1, 0.9]
    assert inf.clip_last_layers_skip_weights == [0.3, 0.7]
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


def test_coerce_as_jax():
    data = {"seed": "123", "plms": "on", "scale": "7.5", "clip_last_layers_skip_weights": "0.3 0.7",
            "embedding_paths": ["a", "b"], "class_prompt": None, "bogus_key": 1}
    assert _same(dataclasses.asdict(twp.from_dict(twp.InferenceSettings, data)),
                 dataclasses.asdict(jwp.from_dict(jwp.InferenceSettings, data)))


# ------------------------------------------------------------ the writer
@pytest.mark.parametrize("data,port_bytes,other", [
    # indentless block sequence under a key, as pyyaml writes it (the
    # indented spelling reads the same but is other bytes)
    ({"w": [0.5, 0.5]}, "w:\n- 0.5\n- 0.5\n", "w:\n  - 0.5\n  - 0.5\n"),
    # an empty list is a flow list
    ({"w": []}, "w: []\n", "w:\n"),
    # number-like and bool-like strings are quoted; others are not
    ({"a": "1", "b": "yes", "c": "null", "d": "1.0", "e": "x"},
     "a: '1'\nb: 'yes'\nc: 'null'\nd: '1.0'\ne: x\n", "a: 1\nb: yes\nc: null\nd: 1.0\ne: x\n"),
    # pyyaml spells a float without a dot with one: 1e-05 would read as a str
    ({"lr": 1e-05, "big": 1e20}, "big: 1.0e+20\nlr: 1.0e-05\n", "big: 1e+20\nlr: 1e-05\n"),
    # '' for the empty string (a bare value reads as None)
    ({"s": "", "n": None}, "n: null\ns: ''\n", "n: null\ns:\n"),
    # quoted where plain would start a comment, a mapping or an indicator
    ({"a": "x #y", "b": "a: b", "c": "- x", "d": " lead", "e": "it's"},
     "a: 'x #y'\nb: 'a: b'\nc: '- x'\nd: ' lead'\ne: it's\n",
     "a: x #y\nb: a: b\nc: - x\nd:  lead\ne: it's\n"),
    ({"inf": float("inf"), "nan": float("nan"), "t": True}, "inf: .inf\nnan: .nan\nt: true\n",
     "inf: inf\nnan: nan\nt: True\n"),
])
def test_safe_dump_traps_equal_pyyaml(data, port_bytes, other):
    want = yaml.safe_dump(data, sort_keys=True)
    assert want == port_bytes
    assert _yaml.safe_dump(data) == want
    assert other != want  # the other choice is other bytes ...
    if not other.startswith("w:\n  -"):
        try:  # ... and reads otherwise, or not at all
            assert not _same(yaml.safe_load(other), yaml.safe_load(want))
        except yaml.YAMLError:
            pass
    assert _same(_yaml.safe_load(want), yaml.safe_load(want))


def test_long_prompt_folds_at_80_columns_as_pyyaml():
    data = {"inference": {"prompt": LONG_PROMPT, "q": "'" + LONG_PROMPT + " it's"}}
    want = yaml.safe_dump(data, sort_keys=True)
    got = _yaml.safe_dump(data)
    assert got == want
    lines = want.splitlines()
    assert len(lines) > 3 and lines[2].startswith("    ")  # a folded continuation line
    unfolded = "inference:\n  prompt: " + LONG_PROMPT + "\n"
    assert unfolded != "\n".join(lines[:3]) + "\n"
    assert _same(_yaml.safe_load(got), data)
    # the reader folds the continuation into one line with a single space
    assert _yaml.safe_load("a: one\n  two\n   three\nb: 1\n") == {"a": "one two three", "b": 1}
    assert _yaml.safe_load("a: 'one\n  two''s\n\n  three'\n") == {"a": "one two's\nthree"}
    assert _yaml.safe_load('a: "x\\\n  \\ y\\ttab"\n') == {"a": "x y\ttab"}


@pytest.mark.parametrize("text", [
    "a:\n- 1\n- x\nb: 2\n", "a:\n  - 1\n  - 'two'\n  -\nb:\n  c:\n  - [1, 2]\n",
    "- 1\n- 2.5\n", "a:\n  b:\n  - yes\n  - ~\n  c: 1\n",
])
def test_reader_reads_block_sequences_as_safe_load(text):
    assert _same(_yaml.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a:\n- b: 1\n", "a:\n- - 1\n", "a:\n  - 1\n - 2\n", "a: one\n  # c\n  two\n",
    "a: one # c\n  two\n", "a: 'x\n", "a:\n-\n  - 1\n",
])
def test_reader_refuses_what_lies_outside(text):
    with pytest.raises(_yaml.YamlError):
        _yaml.safe_load(text)


def test_writer_refuses_what_the_reader_does_not_read():
    for data in ({"a": {}}, {"a": [[1]]}, {"a": [{"b": 1}]}, 3, {}, {"a": object()}):
        with pytest.raises(_yaml.YamlError):
            _yaml.safe_dump(data)


_TEXT = st.text(alphabet=st.sampled_from(list("abz019 .:#-'\"_,[]{}?!&*|>%@`~\\") + ["é", "\n"]),
                max_size=120)
_SCALAR = st.one_of(_TEXT, st.floats(allow_nan=True, allow_infinity=True), st.integers(),
                    st.booleans(), st.none())


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(st.text(alphabet="abcxyz_", min_size=1, max_size=8),
                       st.one_of(_SCALAR, st.lists(_SCALAR, max_size=4)), min_size=1,
                       max_size=6))
def test_generated_documents_equal_pyyaml(data):
    want = yaml.safe_dump(data, sort_keys=True)
    assert _yaml.safe_dump(data) == want
    assert _same(_yaml.safe_load(want), yaml.safe_load(want))
