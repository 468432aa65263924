"""The port's web UI (`adaface_tpu_torch/app.py`) against `scripts/app.py` on
the CPU, the same tiny weights carried across (`test_torch_serve_cli.pipes`)
and the same initial noise drawn from each request's seed (the packages draw
it from different generators, so both pipelines take it as x_T here):

- `render`: escaping and the defaults, equal to JAX's page;
- `generate`: the strip within one uint8 level of the JAX `App`'s for DDIM
  requests with and without compel (PLMS through `generate` is held in
  test_torch_serve_cli.py); a different seed falls outside;
- the HTTP round trip on port 0 (GET, then a POST whose PNG decodes to
  `generate`'s strip bit for bit);
- settings persisted across a restart, the file byte for byte JAX's, and two
  concurrent POSTs leaving one consistent settings file."""

import base64
import importlib.util
import os
import re
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from adaface_tpu_torch import app as tapp
from adaface_tpu_torch import txt2img as tt2i
from adaface_tpu_torch import webui_params as twp
from adaface_tpu_torch.data import png

from test_torch_serve_cli import pipes  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
REQUESTS = [dict(prompt="a photo of a z person", neg_prompt="ugly", steps=3, scale_hi=10.0,
                 scale_lo=4.0, seed=5, size=32, n_samples=2, sampler="ddim", compel=0.0),
            dict(prompt="a z on the beach", neg_prompt="", steps=3, seed=6, size=32,
                 n_samples=1, scale_hi=7.5, scale_lo=7.5),
            dict(prompt="a z in a garden", steps=2, seed=7, size=32, n_samples=2,
                 compel=1.0)]


def _levels(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _seeded(monkeypatch, pipe):
    """`pipe.generate` with x_T drawn from numpy's seed instead of its own."""
    real = pipe.generate

    def generate(prompts, seed=0, height=512, width=512, **kw):
        x_T = np.random.default_rng(seed).standard_normal(
            (len(prompts), height // 2, width // 2, 4)).astype(np.float32)
        return real(prompts, seed=seed, height=height, width=width, x_T=x_T, **kw)

    monkeypatch.setattr(pipe, "generate", generate)


@pytest.fixture
def apps(pipes, monkeypatch, tmp_path):  # noqa: F811
    """(JAX app module, JAX App, port App) over the same pipelines, each with
    a settings file of its own."""
    jp, tp = pipes
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location("jax_app_script",
                                                  os.path.join(SCRIPTS, "app.py"))
    japp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(japp)
    monkeypatch.setattr(japp, "build_pipeline", lambda opt: (jp, jp.tokenizer))
    monkeypatch.setattr(tapp, "build_pipeline", lambda opt, device=None: (tp, tp.tokenizer))
    _seeded(monkeypatch, jp)
    _seeded(monkeypatch, tp)
    argv = ["--tiny", "--num_vectors_per_subj_token", "3", "--prompt", "unused"]
    ja = japp.App(japp.parse_args(argv), settings_path=str(tmp_path / "jax.yaml"))
    ta = tapp.App(tt2i.parse_args(argv), settings_path=str(tmp_path / "port.yaml"))
    return japp, ja, ta


def test_render_escapes_and_defaults_as_jax(apps):
    _, ja, ta = apps
    params = {"prompt": 'x"><script>alert(1)</script>', "seed": "<b>"}
    page = ta.render(params)
    assert "<script>" not in page and "&lt;b&gt;" in page
    assert page == ja.render(params)
    # with a settings file the form starts at InferenceSettings' defaults
    assert 'value="20"' in ta.render({}) and ta.render({}) == ja.render({})
    assert "selected>plms" in ta.render({"sampler": "plms"})
    assert 'value="50"' in tapp.App(ta.opt).render({})  # without one, at DEFAULTS


@pytest.mark.parametrize("index", range(len(REQUESTS)))
def test_generate_strip_equals_jax(apps, index):
    _, ja, ta = apps
    want = ja.generate(dict(REQUESTS[index]))
    got = ta.generate(dict(REQUESTS[index]))
    n = REQUESTS[index]["n_samples"]
    assert got.shape == (32, 32 * n, 3) and got.dtype == np.uint8
    assert _levels(got, want) <= 1
    other = ta.generate(dict(REQUESTS[index], seed=REQUESTS[index]["seed"] + 1))
    assert _levels(other, want) > 1  # the seed reaches the noise


def test_http_round_trip_on_port_zero(apps):
    _, _, ta = apps
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tapp.make_handler(ta))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
        assert "adaface-tpu" in page and 'name="prompt"' in page
        data = ("prompt=a photo of a z person&neg_prompt=&steps=2&scale_hi=10&scale_lo=4"
                "&seed=3&size=32&n_samples=2&sampler=ddim&compel=0").encode()
        resp = urllib.request.urlopen(urllib.request.Request(base + "/generate", data=data),
                                      timeout=120).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    b64 = re.search(r'src="data:image/png;base64,([^"]+)"', resp).group(1)
    strip = png.decode(base64.b64decode(b64))
    want = ta.generate(dict(prompt="a photo of a z person", neg_prompt="", steps="2",
                            scale_hi="10", scale_lo="4", seed="3", size="32",
                            n_samples="2", sampler="ddim", compel="0"))
    assert np.array_equal(strip, want)
    assert 'value="3"' in resp  # the page comes back with the request's fields


def test_settings_persist_across_a_restart(apps, monkeypatch, tmp_path):
    japp, ja, ta = apps
    for app in (ja, ta):  # the images do not matter here: no sampling
        monkeypatch.setattr(app.pipe, "generate", lambda prompts, height=512, width=512, **kw:
                            np.zeros((len(prompts), height, width, 3), np.uint8))
        app.generate(dict(REQUESTS[1], sampler="plms"))
    tbytes = (tmp_path / "port.yaml").read_bytes()
    assert tbytes == (tmp_path / "jax.yaml").read_bytes()
    inf, _ = twp.load_settings(str(tmp_path / "port.yaml"))
    assert (inf.seed, inf.sampler, inf.plms, inf.ddim_steps, inf.H) == (6, "plms", True, 3, 32)
    restarted = tapp.App(ta.opt, settings_path=str(tmp_path / "port.yaml"))
    form = tapp.settings_to_form(inf)
    assert form == japp.settings_to_form(inf)
    assert restarted.defaults["seed"] == 6 and restarted.defaults["sampler"] == "plms"
    page = restarted.render({})
    assert 'value="6"' in page and "selected>plms" in page


def test_concurrent_requests_leave_one_consistent_file(apps, tmp_path):
    _, _, ta = apps
    barrier = threading.Barrier(2)
    errors = []

    def post(seed, prompt):
        try:
            barrier.wait()
            ta.generate(dict(REQUESTS[0], seed=seed, prompt=prompt, n_samples=1, steps=1))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=post, args=(11, "a z one")),
               threading.Thread(target=post, args=(12, "a z two"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    inf, _ = twp.load_settings(str(tmp_path / "port.yaml"))
    assert (inf.seed, inf.prompt) in ((11, "a z one"), (12, "a z two"))
    assert not (tmp_path / "port.yaml.tmp").exists()
