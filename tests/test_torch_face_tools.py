"""The port's face tools (`adaface_tpu_torch/tools/`) against the JAX
package's scripts, run in-process (`importlib`, `runpy`) on the same PNG
folders, fp32 on the CPU.

- `gen_face_masks`: the centred default ellipse, an existing mask kept
  without `--overwrite` and rewritten with it; `--use_detector --detector
  retinaface` with `RETINAFACE_PT` naming a synthetic biubug6 `.pth` (both
  read it), and without it (the note, seeded weights); `--detector scrfd`
  with both `init_scrfd`s patched to one carried tiny SCRFD; `--precise
  --route` with `--parsing_ckpt` naming a synthetic face-parsing `.pth` at
  `--parsing_size` 100 (PNGs at 100x100 and one at 120x90, which PIL
  resizes in both) and a missing `--parsing_ckpt` exiting. Masks, moved
  files (`<folder>_trash` / `<folder>_inspect` beside the folder) and the
  printed lines are compared. Where a detector score lies within MARGIN of
  the threshold, or a BiSeNet pixel's class-0 decision or a class's
  presence rests on a logit gap under TIE_GAP, fp32 roundoff could decide:
  each test first checks that its data has none, so equality is exact.
- `filter_faces`, `knn_faces`, `comparefaces`: `ARCFACE_ONNX` names one
  ONNX file of a tiny recognizer (both packages' `iresnet100` made tiny);
  the moved files (with their `_mask.png` / `.txt` companions), the printed
  similarities and the kNN order, `--dry_run` moving nothing.
- `bbox_to_mask` equals JAX's on float boxes (the landmarks unused, the
  centre moved up by 0.08 of the box height).
"""

import argparse
import importlib.util
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from adaface_tpu.models import scrfd as js
from adaface_tpu.models.arcface import IResNetConfig as JIResNetConfig

from adaface_tpu_torch.data import png
from adaface_tpu_torch.interop.bisenet import load_bisenet, map_bisenet_params
from adaface_tpu_torch.models import arcface as ta
from adaface_tpu_torch.models import bisenet as tb
from adaface_tpu_torch.models import retinaface as tr
from adaface_tpu_torch.models import scrfd as ts
from adaface_tpu_torch.tools import comparefaces, filter_faces, gen_face_masks, knn_faces

from test_torch_face_stack import TINY, NCHWOracle, write_oracle_onnx
from torch_face_helpers import (
    biubug6_state_dict,
    face_parsing_state_dict,
    flax_tree,
    perturb_,
    write_blocky_pngs,
    write_pngs,
)

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCRIPTS = os.path.join(ROOT, "scripts")
MARGIN = 1e-4  # of a score from its threshold
TIE_GAP_REL = 2e-5  # of a BiSeNet logit gap, relative to the largest logit
SHAPES = [(96, 96), (120, 90), (64, 80), (100, 100), (80, 64)]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twins(tmp_path, shapes, seed, dark=(), write=write_pngs):
    """Two copies of one PNG folder: (JAX's, the port's)."""
    a = write(str(tmp_path / "jax" / "faces"), shapes, seed, *([dark] if dark else []))
    b = str(tmp_path / "port" / "faces")
    shutil.copytree(a, b)
    return a, b


def _tree(folder):
    """{path relative to the folder's parent: pixels} of every file beside
    and under the folder's parent."""
    root = os.path.dirname(folder)
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if f.endswith(".png"):
                out[os.path.relpath(p, root)] = png.load_image(
                    p, "L" if f.endswith("_mask.png") else "RGB")
            else:
                out[os.path.relpath(p, root)] = np.frombuffer(open(p, "rb").read(), np.uint8)
    return out


def _same_trees(a, b):
    ta_, tb_ = _tree(a), _tree(b)
    assert sorted(ta_) == sorted(tb_)
    for k in ta_:
        np.testing.assert_array_equal(ta_[k], tb_[k], err_msg=k)
    return ta_


def _lines(text, folder):
    return [l.replace(folder, "<dir>") for l in text.strip().splitlines()]


def _jax_opt(folders, **kw):
    opt = dict(folders=folders, use_detector=False, detector="scrfd", score_thresh=0.5,
               overwrite=False, precise=False, parsing_ckpt=None, parsing_size=512,
               route=False)
    opt.update(kw)
    return argparse.Namespace(**opt)


def _run_both(capsys, jfolder, tfolder, argv, **jkw):
    assert _script("gen_face_masks").main(_jax_opt([jfolder], **jkw)) == 0
    jout = _lines(capsys.readouterr().out, jfolder)
    assert gen_face_masks.main([tfolder] + argv, device="cpu") == 0
    tout = _lines(capsys.readouterr().out, tfolder)
    return jout, tout


def test_bbox_to_mask_matches_jax():
    jg = _script("gen_face_masks")
    for bbox in [(10.3, 12.7, 50.2, 70.9), (-5.0, 3.5, 40.0, 30.25), (20, 20, 21, 21)]:
        np.testing.assert_array_equal(gen_face_masks.bbox_to_mask((64, 72, 3), bbox, None),
                                      jg.bbox_to_mask((64, 72, 3), bbox, None))
    # the other choice: the ellipse centred on the box, not lifted by 0.08 of its height
    x1, y1, x2, y2 = 10.3, 12.7, 50.2, 70.9
    lift = 0.08 * (y2 - y1)
    centred = gen_face_masks.bbox_to_mask((64, 72), (x1, y1 + lift, x2, y2 + lift))
    assert (centred != jg.bbox_to_mask((64, 72), (x1, y1, x2, y2))).sum() > 20
    lm = np.zeros((5, 2))
    np.testing.assert_array_equal(gen_face_masks.bbox_to_mask((64, 72), (10, 10, 40, 50), lm),
                                  gen_face_masks.bbox_to_mask((64, 72), (10, 10, 40, 50)))


def test_default_ellipse_and_overwrite(tmp_path, capsys):
    jdir, tdir = _twins(tmp_path, SHAPES, 0)
    for d in (jdir, tdir):
        png.write(os.path.join(d, "1_mask.png"), np.zeros((120, 90), np.uint8))
    jout, tout = _run_both(capsys, jdir, tdir, [])
    assert jout == tout == ["<dir>: wrote 4 masks"]
    files = _same_trees(jdir, tdir)
    assert not files["faces/1_mask.png"].any()  # kept without --overwrite
    jout, tout = _run_both(capsys, jdir, tdir, ["--overwrite"], overwrite=True)
    assert jout == tout == ["<dir>: wrote 5 masks"]
    files = _same_trees(jdir, tdir)
    assert files["faces/1_mask.png"].any() and files["faces/0_mask.png"].shape == (96, 96)


def _retina_margin_ok(path, folder):
    m = tr.RetinaFace().eval()
    m.load_state_dict(tr.map_retinaface_torch_params(torch.load(path)), strict=True)
    det = tr.RetinaFaceDetector(m)
    found = 0
    for f in sorted(os.listdir(folder)):
        cls = det.heads(png.load_image(os.path.join(folder, f)))[0][:, 1]
        assert np.abs(cls - 0.5).min() > MARGIN, f
        found += bool((cls > 0.5).any())
    return found


def test_retinaface_masks_match_jax(tmp_path, capsys, monkeypatch):
    jdir, tdir = _twins(tmp_path, SHAPES, 1, dark=(2,))
    path = str(tmp_path / "mobilenet0.25_Final.pth")
    torch.save(biubug6_state_dict(1, cls_bias=(0.0, -1.9)), path)
    found = _retina_margin_ok(path, jdir)
    assert 0 < found < len(SHAPES)
    monkeypatch.setenv("RETINAFACE_PT", path)
    jout, tout = _run_both(capsys, jdir, tdir, ["--use_detector", "--detector", "retinaface"],
                           use_detector=True, detector="retinaface")
    assert jout == tout
    assert sum(l.startswith("no face") for l in tout) == len(SHAPES) - found
    assert tout[-1] == f"<dir>: wrote {found} masks"
    _same_trees(jdir, tdir)
    monkeypatch.delenv("RETINAFACE_PT")
    assert gen_face_masks.main([tdir, "--use_detector", "--detector", "retinaface",
                                "--overwrite"], device="cpu") == 0
    assert "no RETINAFACE_PT" in capsys.readouterr().out


def test_biggest_face_by_area(tmp_path, capsys, monkeypatch):
    """Both tools take the face of the biggest box, not the best score: a
    stub detector (two faces, the bigger one scored lower) in place of
    RetinaFace's."""
    from adaface_tpu.models import retinaface as jr

    lm = np.zeros((5, 2), np.float32)
    faces = [(np.array([5, 5, 20, 20], np.float32), lm, 0.9),
             (np.array([30, 20, 80, 90], np.float32), lm, 0.6)]
    stub = lambda image: faces
    jdir, tdir = _twins(tmp_path, SHAPES[:2], 7)
    path = str(tmp_path / "mobilenet0.25_Final.pth")
    torch.save(biubug6_state_dict(1), path)
    monkeypatch.setenv("RETINAFACE_PT", path)
    monkeypatch.setattr(jr, "RetinaFaceDetector", lambda *a, **k: stub)
    monkeypatch.setattr(gen_face_masks, "make_detector", lambda opt, dev: stub)
    argv = ["--use_detector", "--detector", "retinaface"]
    jout, tout = _run_both(capsys, jdir, tdir, argv, use_detector=True, detector="retinaface")
    assert jout == tout
    files = _same_trees(jdir, tdir)
    mask = files["faces/0_mask.png"]
    np.testing.assert_array_equal(mask, gen_face_masks.bbox_to_mask(mask.shape, faces[1][0]))
    assert not np.array_equal(mask, gen_face_masks.bbox_to_mask(mask.shape, faces[0][0]))


def test_scrfd_masks_match_jax(tmp_path, capsys, monkeypatch):
    port = perturb_(ts.init_scrfd(0, ts.SCRFDConfig.tiny()), 1)
    with torch.no_grad():
        port.head.cls_pred.bias.fill_(-2.5)
    params, _ = flax_tree(port)
    jdir, tdir = _twins(tmp_path, SHAPES, 2, dark=(4,))
    det = ts.SCRFDDetector(port)
    found = 0
    for f in sorted(os.listdir(jdir)):
        x, _ = det.prepare(png.load_image(os.path.join(jdir, f)))
        s = np.concatenate([h[0].reshape(-1) for h in det.heads(x)])
        assert np.abs(s - 0.5).min() > MARGIN, f
        found += bool((s >= 0.5).any())
    assert 0 < found < len(SHAPES)
    monkeypatch.setattr(js, "init_scrfd", lambda key: (js.SCRFD(js.SCRFDConfig.tiny()), params))
    monkeypatch.setattr(ts, "init_scrfd", lambda seed, cfg=None, device=None: port)
    jout, tout = _run_both(capsys, jdir, tdir, ["--use_detector"], use_detector=True)
    assert jout == tout and tout[-1] == f"<dir>: wrote {found} masks"
    _same_trees(jdir, tdir)


def _class_bias(folder, size):
    """A class bias that evens out the synthetic parser's classes (0.8 of
    minus each class's mean logit over the folder): parts counts then
    spread across the routing thresholds."""
    model = load_bisenet_from(face_parsing_state_dict(5))
    lg = torch.cat([_logits(model, folder, f, size) for f in sorted(os.listdir(folder))])
    return -0.8 * lg.mean(dim=(0, 1)).numpy()


def load_bisenet_from(sd):
    m = tb.BiSeNet().eval()
    m.load_state_dict(map_bisenet_params({k: v.numpy() for k, v in sd.items()}), strict=True)
    return m


def _logits(model, folder, f, size):
    img = gen_face_masks.pil_resize(png.load_image(os.path.join(folder, f)), (size, size),
                                    "bilinear")
    with torch.no_grad():
        return model(tb.preprocess(torch.from_numpy(img[None])))[0]


def _parse_robust(path, folder, size):
    """Each image's parts count, checked to rest on no logit gap under
    TIE_GAP_REL of the largest logit: every pixel's class-0 decision, and
    each class's presence (some pixel's margin over the best other class
    above it) or absence (every pixel's margin below minus it)."""
    model = load_bisenet(path)
    counts = []
    for f in sorted(os.listdir(folder)):
        lg = _logits(model, folder, f, size)
        tie = TIE_GAP_REL * float(lg.abs().max())
        (b1, b2), k1 = lg.topk(2, -1).values.unbind(-1), lg.argmax(-1)
        other = torch.where(k1[..., None] == torch.arange(lg.shape[-1]), b2[..., None],
                            b1[..., None])
        margin = lg - other  # each class against the best other class
        assert float(margin[..., 0].abs().min()) > tie, f
        best = margin.flatten(0, 1).max(0).values
        assert bool((best.abs() > tie).all()), f
        counts.append(int((best > 0).sum()))
    return counts


def test_precise_route_matches_jax(tmp_path, capsys):
    shapes = [(100, 100)] * 4 + [(120, 90)]
    jdir, tdir = _twins(tmp_path, shapes, 3)
    for d in (jdir, tdir):  # a flat image: few parts
        png.write(os.path.join(d, "5.png"), np.full((100, 100, 3), 128, np.uint8))
    path = str(tmp_path / "79999_iter.pth")
    torch.save(face_parsing_state_dict(5, _class_bias(jdir, 100)), path)
    counts = _parse_robust(path, jdir, 100)
    assert min(counts) <= 9 and max(counts) >= 18 and any(9 < c < 18 for c in counts), counts
    n_mask = sum(9 < c < 18 for c in counts)
    n_trash = sum(c <= 9 for c in counts)
    argv = ["--precise", "--route", "--parsing_ckpt", path, "--parsing_size", "100"]
    jout, tout = _run_both(capsys, jdir, tdir, argv, precise=True, route=True,
                           parsing_ckpt=path, parsing_size=100)
    assert jout == tout == [f"<dir>: wrote {n_mask} masks (trash {n_trash}, inspect "
                            f"{len(counts) - n_mask - n_trash})"]
    files = _same_trees(jdir, tdir)
    assert "faces_trash/5.png" in files and any(k.startswith("faces_inspect/") for k in files)
    missing = ["--precise", "--parsing_ckpt", str(tmp_path / "nope.pth")]
    with pytest.raises(SystemExit, match="not found"):
        gen_face_masks.main([tdir] + missing, device="cpu")
    with pytest.raises(SystemExit, match="not found"):
        _script("gen_face_masks").main(_jax_opt([jdir], precise=True,
                                                parsing_ckpt=str(tmp_path / "nope.pth")))


# ------------------------------------------------ the recognizer's tools

@pytest.fixture
def onnx_env(tmp_path, monkeypatch):
    """ARCFACE_ONNX: one tiny recognizer's ONNX file for both packages."""
    path = str(tmp_path / "arcface.onnx")
    with torch.random.fork_rng():  # the oracle's convs draw from the global generator
        torch.manual_seed(16)
        write_oracle_onnx(path, NCHWOracle(16))
    monkeypatch.setenv("ARCFACE_ONNX", path)
    tiny = classmethod(lambda cls: cls(**TINY, input_size=16))
    monkeypatch.setattr(JIResNetConfig, "iresnet100", tiny)
    monkeypatch.setattr(ta.IResNetConfig, "iresnet100", tiny)
    monkeypatch.syspath_prepend(SCRIPTS)  # the JAX scripts import filter_faces
    monkeypatch.setattr(sys, "path", list(sys.path))
    return path


def _sims(app, folder):
    """Each image's similarity to the folder's mean embedding, by index."""
    embs = np.stack([app.embed_image(png.load_image(os.path.join(folder, f"{i}.png")))
                     for i in range(len(os.listdir(folder)))])
    mean = embs.mean(0)
    return embs @ (mean / np.linalg.norm(mean))


def test_filter_faces_matches_jax(tmp_path, capsys, onnx_env):
    from adaface_tpu_torch.face_app import default_face_app

    jdir, tdir = _twins(tmp_path, SHAPES, 4, write=write_blocky_pngs)
    sims = _sims(default_face_app("cpu"), tdir)
    # a threshold in the widest gap: at least one image moves, one stays
    srt = np.sort(sims)
    i = int(np.argmax(np.diff(srt)))
    threshold = float((srt[i] + srt[i + 1]) / 2)
    assert np.abs(sims - threshold).min() > MARGIN
    low = int(np.argmin(sims))  # moved, with its companions
    for d in (jdir, tdir):
        open(os.path.join(d, f"{low}.txt"), "w").write("a caption")
        png.write(os.path.join(d, f"{low}_mask.png"), np.zeros((8, 8), np.uint8))
    jff = _script("filter_faces")
    japp = jff.default_face_app()
    capsys.readouterr()
    jff.filter_folder(japp.embed_image, jdir, threshold, dry_run=True)
    jdry = _lines(capsys.readouterr().out, jdir)
    assert filter_faces.main([tdir, "--threshold", str(threshold), "--dry_run"],
                             device="cpu") == 0
    assert _lines(capsys.readouterr().out, tdir) == jdry
    assert not os.path.exists(os.path.join(tdir, "trash"))
    jff.filter_folder(japp.embed_image, jdir, threshold)
    jout = _lines(capsys.readouterr().out, jdir)
    assert filter_faces.main([tdir, "--threshold", str(threshold)], device="cpu") == 0
    assert _lines(capsys.readouterr().out, tdir) == jout == jdry
    files = _same_trees(jdir, tdir)
    moved = [k for k in files if k.startswith("faces/trash/") and k.endswith(".png")
             and not k.endswith("_mask.png")]
    assert 0 < len(moved) < len(SHAPES)
    for name in (f"{low}.png", f"{low}.txt", f"{low}_mask.png"):
        assert f"faces/trash/{name}" in files


def _parse_knn(lines):
    return [(float(s), os.path.basename(p)) for s, p in (l.split("  ") for l in lines)]


def test_knn_and_comparefaces_match_jax(tmp_path, capsys, onnx_env, monkeypatch):
    a = write_blocky_pngs(str(tmp_path / "a"), SHAPES, 5)
    b = write_blocky_pngs(str(tmp_path / "b"), SHAPES[:3], 6)
    q = os.path.join(a, "0.png")
    _script("knn_faces").main(argparse.Namespace(query=q, gallery=[a, b], k=6))
    jout = _parse_knn(capsys.readouterr().out.strip().splitlines())
    assert knn_faces.main(["--query", q, "--gallery", a, b, "-k", "6"], device="cpu") == 0
    tout = _parse_knn(capsys.readouterr().out.strip().splitlines())
    assert [p for _, p in tout] == [p for _, p in jout] and len(tout) == 6
    np.testing.assert_allclose([s for s, _ in tout], [s for s, _ in jout], atol=1.5e-4)
    assert tout[0] == (1.0, "0.png")

    for argv in ([a, b], [a, "--self"], [b]):
        monkeypatch.setattr(sys, "argv", ["comparefaces.py"] + argv)
        runpy.run_path(os.path.join(SCRIPTS, "comparefaces.py"), run_name="__main__")
        jline = capsys.readouterr().out.strip().splitlines()[-1]
        assert comparefaces.main(argv, device="cpu") == 0
        tline = capsys.readouterr().out.strip().splitlines()[-1]
        jsim, tsim = (float(l.split("face sim ")[1].split()[0]) for l in (jline, tline))
        assert abs(jsim - tsim) < 1.5e-4 and tline.split("face sim")[0] == jline.split(
            "face sim")[0] and tline.split("(")[1] == jline.split("(")[1]
