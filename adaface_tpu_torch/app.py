"""Web UI for subject-driven generation (counterpart of `scripts/app.py`): a
browser form over the port's txt2img pipeline, with the last request's
fields persisted between runs (`webui_params.py`, the reference's
`webui-setting-config.yaml` round trip).

    python -m adaface_tpu_torch.app --ckpt sd-v1-5.ckpt \\
        --embedding_paths embeddings_gs-4500.pt --port 7860

Every option other than `--port`, `--host` and `--settings` is
`txt2img.py`'s. It serves through gradio where gradio imports, else through
the standard library's `ThreadingHTTPServer` (one page, a POST per request;
the card's machine has no gradio). One request runs on the card at a time,
and its fields are written back inside the same lock, so concurrent POSTs
leave one consistent settings file. The page's image is a PNG written by the
port's codec (`data/png.py`). It runs on the CUDA card; `--device cpu` (or
`main(..., device="cpu")`) runs it on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import html
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs

import numpy as np

from adaface_tpu_torch.data import png
from adaface_tpu_torch.txt2img import build_pipeline, pad_placeholders, parse_args
from adaface_tpu_torch.webui_params import load_settings, update_settings

# fallback defaults; `App` takes these from the persisted settings
DEFAULTS = dict(prompt="a z in a garden", neg_prompt="", steps=50,
                scale_hi=10.0, scale_lo=4.0, seed=0, size=512,
                n_samples=2, sampler="ddim", compel=0.0)


def settings_to_form(s) -> dict:
    """InferenceSettings -> the UI's form-parameter dict."""
    return dict(prompt=s.prompt, neg_prompt=s.neg_prompt,
                steps=int(s.ddim_steps), scale_hi=float(s.scale),
                scale_lo=float(s.scale_min), seed=int(s.seed),
                size=int(s.H), n_samples=int(s.n_samples),
                sampler=("plms" if s.plms else s.sampler),
                compel=float(s.compel))


PAGE = """<!doctype html><html><head><title>adaface-tpu</title>
<style>body{{font-family:sans-serif;max-width:780px;margin:2em auto}}
label{{display:block;margin-top:.6em}}input,select{{width:100%}}
.row{{display:flex;gap:1em}}.row>div{{flex:1}}
img{{max-width:100%;margin-top:1em;border:1px solid #ccc}}</style></head>
<body><h2>adaface-tpu &mdash; subject-driven txt2img</h2>
<form method="post" action="/generate">
<label>Prompt <input name="prompt" value="{prompt}"></label>
<label>Negative prompt <input name="neg_prompt" value="{neg_prompt}"></label>
<div class="row">
<div><label>Steps <input name="steps" type="number" value="{steps}"></label></div>
<div><label>CFG start <input name="scale_hi" value="{scale_hi}"></label></div>
<div><label>CFG end <input name="scale_lo" value="{scale_lo}"></label></div>
<div><label>Seed <input name="seed" type="number" value="{seed}"></label></div>
</div>
<div class="row">
<div><label>Size <input name="size" type="number" value="{size}"></label></div>
<div><label>Samples <input name="n_samples" type="number" value="{n_samples}"></label></div>
<div><label>Sampler <select name="sampler">
<option {ddim_sel}>ddim</option><option {plms_sel}>plms</option>
</select></label></div>
<div><label>Compel level <input name="compel" value="{compel}"></label></div>
</div>
<button style="margin-top:1em" type="submit">Generate</button></form>
{result}</body></html>"""


class App:
    def __init__(self, opt, settings_path: Optional[str] = None, *, device=None):
        self.opt = opt
        self.pipe, _ = build_pipeline(opt, device)
        self.lock = threading.Lock()  # one request on the card at a time
        # the form comes up with whatever the last session used
        self.settings_path = settings_path
        self.defaults = dict(DEFAULTS)
        if settings_path:
            inf, _tr = load_settings(settings_path)
            self.defaults.update(settings_to_form(inf))

    def render(self, params, result=""):
        p = dict(self.defaults, **params)
        return PAGE.format(
            ddim_sel="selected" if p["sampler"] == "ddim" else "",
            plms_sel="selected" if p["sampler"] == "plms" else "",
            result=result,
            **{k: html.escape(str(v)) for k, v in p.items() if k != "sampler"})

    def generate(self, p) -> np.ndarray:
        """The request's images side by side, uint8 [size, n * size, 3]."""
        p = dict(self.defaults, **p)  # missing fields fall back to defaults
        prompt = pad_placeholders(p["prompt"], self.opt.subject_string,
                                  self.opt.num_vectors_per_subj_token)
        with self.lock:
            imgs = self.pipe.generate(
                [prompt] * int(p["n_samples"]),
                negative_prompt=p["neg_prompt"] or "",
                num_steps=int(p["steps"]),
                guidance_scale=(float(p["scale_hi"]), float(p["scale_lo"])),
                height=int(p["size"]), width=int(p["size"]),
                seed=int(p["seed"]), sampler=p["sampler"],
                compel_cfg_weight_level=float(p["compel"]))
            # inside the lock: concurrent requests would otherwise race the
            # settings' load-modify-write and self.defaults
            self._persist(p)
        return np.concatenate(list(imgs), axis=1)

    def _persist(self, p):
        """Write the just-used fields back, so that every one survives a
        restart (the reference writes back the latest seed)."""
        if not self.settings_path:
            return
        self.defaults.update(p)
        update_settings(
            self.settings_path, prompt=p["prompt"],
            neg_prompt=p["neg_prompt"], ddim_steps=int(p["steps"]),
            scale=float(p["scale_hi"]), scale_min=float(p["scale_lo"]),
            seed=int(p["seed"]), H=int(p["size"]), W=int(p["size"]),
            n_samples=int(p["n_samples"]), plms=(p["sampler"] == "plms"),
            sampler=p["sampler"], compel=float(p["compel"]))


def make_handler(app: App):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, body, ctype="text/html"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send(app.render({}))

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            q = parse_qs(self.rfile.read(n).decode("utf-8", "replace"), keep_blank_values=True)
            params = {k: v[0] for k, v in q.items()}
            try:
                b64 = base64.b64encode(png.encode(app.generate(params))).decode()
                result = f'<img src="data:image/png;base64,{b64}">'
            except Exception as e:  # surface errors in the page
                result = f"<pre>{html.escape(repr(e))}</pre>"
            self._send(app.render(params, result))

        def log_message(self, fmt, *args):
            print("[http]", fmt % args, flush=True)

    return Handler


def run_gradio(app: App, port: int):
    import gradio as gr

    def fn(prompt, neg, steps, hi, lo, seed, size, n, sampler, compel):
        return app.generate(dict(prompt=prompt, neg_prompt=neg, steps=steps,
                                 scale_hi=hi, scale_lo=lo, seed=seed,
                                 size=size, n_samples=n, sampler=sampler,
                                 compel=compel))

    d = app.defaults  # persisted settings as initial values
    gr.Interface(
        fn,
        [gr.Textbox(value=d["prompt"]), gr.Textbox(value=d["neg_prompt"]),
         gr.Number(value=d["steps"]), gr.Number(value=d["scale_hi"]),
         gr.Number(value=d["scale_lo"]), gr.Number(value=d["seed"]),
         gr.Number(value=d["size"]), gr.Number(value=d["n_samples"]),
         gr.Dropdown(["ddim", "plms"], value=d["sampler"]),
         gr.Number(value=d["compel"])],
        gr.Image(),
        title="adaface-tpu",
    ).launch(server_port=port)


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Serve until interrupted. `argv` defaults to the command line; `device`
    overrides `--device`."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--settings", type=str, default="webui-settings.yaml",
                   help="persisted UI settings; '' disables")
    extra, rest = p.parse_known_args(sys.argv[1:] if argv is None else list(argv))
    opt = parse_args(rest + ["--prompt", "unused"])
    app = App(opt, settings_path=extra.settings or None, device=device)
    try:
        import gradio  # noqa: F401
    except ImportError:
        gradio = None
    if gradio is not None:
        run_gradio(app, extra.port)
        return 0
    srv = ThreadingHTTPServer((extra.host, extra.port), make_handler(app))
    print(json.dumps({"serving": f"http://{extra.host}:{srv.server_address[1]}"}), flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
