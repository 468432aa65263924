"""The port's evaluation and generation CLIs against the JAX package's scripts
on the CPU (`scripts/{gen_subjects_and_eval,evaluate_subjects,gen_db_reg,
zero_shot_test}.py`, run in-process):

- `gen_subjects_and_eval`: the prompt manifests byte for byte under each
  selection and prompt option; `find_newest_embeddings` with mtimes set
  against the names' order (the trap: sorting by name picks another file);
  `resolve_z_suffix` over every `--method` and `--z_suffix_type`; the
  `--dryrun` argv; `all_scores.csv` and its `MEAN` row byte for byte from
  the same per-subject `scores.csv` rows (face columns only where present).
  End to end at `--tiny` on the CPU: a prompt's images equal `txt2img.main`
  on the printed argv bit for bit, the CSV holds the subject's rows, and
  `evaluate_subjects` on the tree gives the same CLIP-I and DINO means.
- `evaluate_subjects`: the same tree scored by both packages with the same
  HF-format scorer files (`CLIP_SCORER_PT`, `DINO_VITS16_PT`): every CSV
  value within 2e-4 (one unit of its 4th decimal), the duplicate prompt and
  the subject without rows skipped alike.
- `gen_db_reg`: the batches' argv and the flattened folder as JAX's; end to
  end at `--tiny`, batch 0 equal to `txt2img.main` bit for bit and the
  DreamBooth loader reading the folder.
- `zero_shot_test`: the three arms on JAX's seeded weights (PRNGKey 3/4/5,
  carried across by `interop/from_jax.py`) and the same pipeline weights:
  the printed statistics within 1.5e-4 (their 4 decimals), the images within
  one uint8 level; the inverse arm's refusal of a context not 77 wide."""

import csv
import importlib.util
import itertools
import os
import re
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from adaface_tpu.models import clip_text as jct
from adaface_tpu.models import clip_vision as jcv
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.personalization.arc2face import INVERSE_TEMPLATE
from adaface_tpu.personalization.subj_basis_generator import SubjBasisGenerator as JGen
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

from adaface_tpu_torch import evaluate_subjects as tev
from adaface_tpu_torch import gen_subjects_and_eval as tgen
from adaface_tpu_torch import txt2img as tt2i
from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.personalized_db import DreamBoothDataset
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import clip_text as tct
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.tools import gen_db_reg as tdb
from adaface_tpu_torch.tools import zero_shot_test as tzs

from test_torch_evaluation import _hf_files, _patch_tiny_configs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
SUBJECT_FILE = """\
# three subjects: a face, an object, a cartoon
set -g subjects alice rex-dog carol
set -g class_names "woman" "dog" "girl"
set -g cls_delta_strings "young woman" "corgi dog" "cartoon girl"
set -g broad_classes 1 0 2
set -g are_faces 1 0 1
set -g data_folder subjects
set -g sel_set 1 2
"""


@pytest.fixture
def jax_scripts(monkeypatch):
    """name -> the JAX script loaded from `scripts/` (which it imports
    `txt2img` and `filter_faces` from)."""
    monkeypatch.syspath_prepend(SCRIPTS)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in ("txt2img", "filter_faces"):  # what the scripts import inside main
        importlib.import_module(name)

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_{name}_script",
                                                      os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


@pytest.fixture
def subject_file(tmp_path):
    path = tmp_path / "info.sh"
    path.write_text(SUBJECT_FILE)
    return str(path)


def _outputs(capsys, *roots):
    out = capsys.readouterr().out
    for i, r in enumerate(roots):
        out = out.replace(str(r), f"<root{i}>")
    return out


# ------------------------------------------------------ gen_subjects_and_eval
@pytest.mark.parametrize("argv", [
    ["--prompt_set", "all"],
    ["--prompt_set", "community", "--prompt_prefix", "masterpiece", "--prompt_suffix", "4k",
     "--include_bg_string", "--z_prefix", "photo of"],
    ["--method", "db", "--extra_z_suffix", "smiling", "--max_prompts", "3", "--range", "1-3"],
    ["--selset"], ["--skipselset"], ["--skipselset", "--range", "2-3"],
    ["--z_suffix_type", ", wearing a hat", "--range", "1,3"],
])
def test_manifests_equal_jax(jax_scripts, subject_file, tmp_path, capsys, argv):
    jgen = jax_scripts("gen_subjects_and_eval")
    jout, tout = tmp_path / "jax", tmp_path / "port"
    base = ["--subject_file", subject_file, "--gen_prompt_set_only"]
    assert jgen.main(jgen.parse_args(base + argv + ["--outdir", str(jout)])) == 0
    jprint = _outputs(capsys, jout)
    assert tgen.main(base + argv + ["--outdir", str(tout)], device="cpu") == 0
    tprint = _outputs(capsys, tout)
    assert tprint == jprint
    files = sorted(os.listdir(jout))
    assert files and sorted(os.listdir(tout)) == files
    for f in files:
        assert (tout / f).read_bytes() == (jout / f).read_bytes(), f
        rows = list(csv.reader(open(tout / f), delimiter="\t"))
        assert all(r[0] == "1" and re.fullmatch(r"p\d\d", r[1]) for r in rows)


def test_resolve_z_suffix_over_every_option(jax_scripts):
    jgen = jax_scripts("gen_subjects_and_eval")
    n = 0
    for method, zst, broad, extra in itertools.product(
            ("ada", "ti", "static", "db"),
            (None, "", "class_name", "cls_delta_string", "wearing a hat", ", in red",
             "_under"),
            (0, 1, 2), ("", "smiling")):
        opt = SimpleNamespace(method=method, z_suffix_type=zst, extra_z_suffix=extra)
        want = jgen.resolve_z_suffix(opt, broad, "dog", "corgi dog")
        assert tgen.resolve_z_suffix(opt, broad, "dog", "corgi dog") == want
        n += 1
    assert n == 4 * 7 * 3 * 2


def test_find_newest_embeddings_by_mtime(jax_scripts, tmp_path):
    jgen = jax_scripts("gen_subjects_and_eval")
    files = {"alice-2024/embeddings_gs-100.npz": 300, "alice-2024/embeddings_gs-200.npz": 100,
             "alice-2023/embeddings_gs-50.pt": 200, "alice-2023/embeddings_7.npz": 50,
             "run-rex-dog/embeddings_gs-9.pt": 10, "alice-2024/notes_gs-999.npz": 999}
    for rel, mtime in files.items():
        path = tmp_path / rel
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(b"x")
        os.utime(path, (mtime, mtime))
    for subject, it in (("alice", None), ("alice", 100), ("alice", 200), ("alice", 7),
                        ("alice", 50), ("alice", 999), ("rex-dog", None), ("bob", None)):
        want = jgen.find_newest_embeddings(str(tmp_path), subject, it)
        assert tgen.find_newest_embeddings(str(tmp_path), subject, it) == want
    newest = tgen.find_newest_embeddings(str(tmp_path), "alice")
    assert newest.endswith("embeddings_gs-100.npz")  # the newest file ...
    by_name = sorted(p for p in files if p.startswith("alice") and "embeddings_" in p)[-1]
    assert not newest.endswith(by_name)  # ... not the last name


def _gt_tree(tmp_path, subjects=("alice", "rex-dog"), n=2, size=32):
    root = tmp_path / "subjects"
    for i, s in enumerate(subjects):
        (root / s).mkdir(parents=True)
        g = np.random.default_rng(i)
        for k in range(n):
            png.write(str(root / s / f"{k}.png"),
                      g.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return root


def test_dryrun_argv_equals_jax(jax_scripts, subject_file, tmp_path, capsys):
    jgen = jax_scripts("gen_subjects_and_eval")
    root = _gt_tree(tmp_path)
    logdir = tmp_path / "logs"
    (logdir / "alice-1").mkdir(parents=True)
    (logdir / "alice-1" / "embeddings_gs-10.npz").write_bytes(b"x")
    argv = ["--subject_file", subject_file, "--data_root", str(root), "--logdir", str(logdir),
            "--range", "1-3", "--dryrun", "--ckpt", "sd.ckpt", "--tiny", "--steps", "3",
            "--n_samples", "2", "--size", "64", "--max_prompts", "2"]
    out = tmp_path / "out"
    assert jgen.main(jgen.parse_args(argv + ["--outdir", str(out)])) == 0
    jprint = _outputs(capsys, out, tmp_path)
    assert tgen.main(argv + ["--outdir", str(out)], device="cpu") == 0
    tprint = _outputs(capsys, out, tmp_path)
    assert tprint == jprint
    lines = [ln for ln in tprint.splitlines() if ln.startswith("   txt2img ")]
    assert len(lines) == 3
    assert "--calc_face_sim" in lines[0] and "--compare_with" in lines[0]
    assert "--compare_with" in lines[1] and "--calc_face_sim" not in lines[1]  # not a face
    assert "--compare_with" not in lines[2]  # carol has no ground-truth folder


def _fake_txt2img(rows_by_subject):
    """A txt2img main that appends the subject's given rows to
    `<out>/scores.csv`, by the `--out` of its argv."""
    def main(argv):
        out = argv[argv.index("--out") + 1]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "scores.csv"), "a") as f:
            csv.writer(f).writerows(rows_by_subject[os.path.basename(out)])
        return 0
    return main


ROWS = {"alice": [["a photo of a young woman", "0.8123", "0.2501", "0.6012", "0.4410", "1",
                   "0.2500"]],
        "rex-dog": [["a photo of a dog", "0.7001", "0.2999", "0.5555"]],
        "carol": [["a girl", "0.1", "0.2", "0.3", "0.9", "0", "0.0000"],
                  ["a girl again", "0.3", "0.4", "0.5", "0.7", "2", "0.5000"]]}


@pytest.mark.parametrize("selection", [["--range", "1-3"], ["--range", "2"]])
def test_all_scores_csv_equals_jax(jax_scripts, subject_file, tmp_path, capsys, monkeypatch,
                                   selection):
    jgen = jax_scripts("gen_subjects_and_eval")
    jt2i = sys.modules["txt2img"]  # the JAX script's, as gen_subjects imports it
    monkeypatch.setattr(jt2i, "parse_args", lambda argv: argv)
    monkeypatch.setattr(jt2i, "main", _fake_txt2img(ROWS))
    monkeypatch.setattr(tt2i, "main", lambda argv, device=None: _fake_txt2img(ROWS)(argv))
    argv = ["--subject_file", subject_file, "--logdir", str(tmp_path / "none")] + selection
    jout, tout = tmp_path / "jax", tmp_path / "port"
    assert jgen.main(jgen.parse_args(argv + ["--outdir", str(jout)])) == 0
    jprint = _outputs(capsys, jout)
    assert tgen.main(argv + ["--outdir", str(tout)], device="cpu") == 0
    tprint = _outputs(capsys, tout)
    assert tprint == jprint
    got = (tout / "all_scores.csv").read_bytes()
    assert got == (jout / "all_scores.csv").read_bytes()
    rows = list(csv.reader(open(tout / "all_scores.csv")))
    mean = rows[-1]
    body = rows[1:-1]
    assert mean[0] == "MEAN"
    for k in range(3):  # the MEAN row is the rows' mean to its 4 decimals
        assert float(mean[2 + k]) == pytest.approx(np.mean([float(r[2 + k]) for r in body]),
                                                   abs=5e-5)
    assert (mean[5] == "") == (selection == ["--range", "2"])  # face columns only if present


@pytest.fixture
def tiny_tree(tmp_path):
    """A subject file of one face subject with ground truth and an `.npz` of
    its embeddings at the `--tiny` CLIP width."""
    root = _gt_tree(tmp_path, subjects=("alice",), n=2, size=32)
    info = tmp_path / "one.sh"
    info.write_text("set -g subjects alice\nset -g class_names woman\n"
                    "set -g cls_delta_strings \"young woman\"\nset -g data_folder subjects\n"
                    "set -g are_faces 1\n")
    logdir = tmp_path / "logs" / "alice-run"
    logdir.mkdir(parents=True)
    mgr = EmbeddingManager()
    mgr.add_placeholder("z", token_id=HashTokenizer().add_placeholder("z"), num_vectors=2,
                        emb_dim=64, rank=3, generator=torch.Generator().manual_seed(3))
    mgr.save_native(str(logdir / "embeddings_gs-5.npz"))
    return SimpleNamespace(root=root, info=str(info), logdir=str(tmp_path / "logs"))


def test_gen_subjects_end_to_end_and_evaluate(tiny_tree, tmp_path, capsys, monkeypatch):
    out = tmp_path / "eval"
    argv = ["--subject_file", tiny_tree.info, "--data_root", str(tiny_tree.root),
            "--logdir", tiny_tree.logdir, "--tiny", "--steps", "2", "--size", "32",
            "--n_samples", "2", "--max_prompts", "2", "--outdir", str(out)]
    assert tgen.main(argv + ["--dryrun"], device="cpu") == 0
    printed = re.search(r"^   txt2img (.*)$", capsys.readouterr().out, re.M).group(1)
    calls, real = [], tt2i.main
    monkeypatch.setattr(tt2i, "main", lambda a, device=None: (calls.append(list(a)),
                                                              real(a, device=device))[1])
    assert tgen.main(argv, device="cpu") == 0
    capsys.readouterr()
    t2i_argv = calls[0]
    assert " ".join(t2i_argv) == printed  # the argv that --dryrun prints
    rerun = tmp_path / "rerun"
    t2i_argv[t2i_argv.index("--out") + 1] = str(rerun)
    assert real(t2i_argv, device="cpu") == 0
    for sub in ("p00", "p01"):
        names = sorted(os.listdir(out / "alice" / sub))
        assert names == ["00000.png", "00001.png"]
        for name in names:
            assert np.array_equal(png.read(str(out / "alice" / sub / name)),
                                  png.read(str(rerun / sub / name)))
    rows = list(csv.reader(open(out / "all_scores.csv")))
    sub_rows = list(csv.reader(open(out / "alice" / "scores.csv")))
    assert rows[1:-1] == [["alice"] + r for r in sub_rows] and len(sub_rows[0]) == 7
    means = [float(x) for x in rows[-1][2:5]]
    for k in range(3):
        assert means[k] == pytest.approx(float(sub_rows[0][1 + k]), abs=5e-5)
    # evaluate_subjects on the tree: its CLIP-I and DINO means are the
    # generator's (its CLIP-T uses each prompt's own class prompt). The
    # manifest's subfolders sit under the subject's folder, as in JAX.
    csv_path = tmp_path / "rescored.csv"
    shutil.copy(out / "alice-prompts.tsv", out / "alice")
    assert tev.main(["--gt_dir", str(tiny_tree.root), "--samples_dir", str(out / "alice"),
                     "--subject_file", tiny_tree.info, "--num_samples", "2",
                     "--out_csv", str(csv_path)], device="cpu") == 0
    final = list(csv.reader(open(csv_path)))[-1]
    assert final[0] == "MEAN"
    assert float(final[2]) == pytest.approx(means[0], abs=2e-4)
    assert float(final[4]) == pytest.approx(means[2], abs=2e-4)


# ------------------------------------------------------------ evaluate_subjects
def test_evaluate_subjects_equals_jax(jax_scripts, subject_file, tmp_path, capsys, monkeypatch):
    jev = jax_scripts("evaluate_subjects")
    clip_path, dino_path = _hf_files(tmp_path)
    _patch_tiny_configs(monkeypatch)
    monkeypatch.setenv("CLIP_SCORER_PT", clip_path)
    monkeypatch.setenv("DINO_VITS16_PT", dino_path)
    for k in ("CLIP_VOCAB_JSON", "CLIP_MERGES_TXT"):
        monkeypatch.delenv(k, raising=False)
    gt = _gt_tree(tmp_path, subjects=("alice", "rex-dog", "carol"), n=3, size=40)
    samples = tmp_path / "samples"
    g = np.random.default_rng(5)
    for sub in ("alice-p00", "alice-p01", "rex-p00", "rex-p01"):
        (samples / sub).mkdir(parents=True)
        for k in range(3):
            png.write(str(samples / sub / f"{k:05}.png"),
                      g.integers(0, 256, (36, 36, 3), dtype=np.uint8))
    (samples / "alice-prompts.tsv").write_text(
        "1\talice-p00\ta z woman\ta photo of a woman\n"
        "1\talice-p01\ta z woman on a beach\ta woman on a beach\n"
        "1\talice-p00\tthe same again\ta photo of a woman\n")  # a repeated orig prompt
    (samples / "rex-dog-prompts.txt").write_text(  # the reference's 3-column manifest
        "1\trex-p00\ta dog in the snow\n\n1\trex-p01\ta dog on a sofa\n")
    (samples / "carol-prompts.tsv").write_text("")  # no scorable rows: skipped
    argv = ["--gt_dir", str(gt), "--samples_dir", str(samples), "--subject_file", subject_file,
            "--num_samples", "2"]
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "port.csv"
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert jev.main(jev.parse_args(argv + ["--out_csv", str(jcsv)])) == 0
    jprint = _outputs(capsys, jcsv)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert tev.main(argv + ["--out_csv", str(tcsv)], device="cpu") == 0
    tprint = _outputs(capsys, tcsv)
    num = re.compile(r"-?\d+\.\d{3,4}")
    assert num.sub("#", tprint) == num.sub("#", jprint)
    assert "no scorable prompts for carol; skipping" in tprint
    assert tprint.count("Prompt: a photo of a woman") == 1
    for a, b in zip(map(float, num.findall(tprint)), map(float, num.findall(jprint))):
        assert a == pytest.approx(b, abs=1e-3)  # printed to 3 decimals
    trows, jrows = list(csv.reader(open(tcsv))), list(csv.reader(open(jcsv)))
    assert len(trows) == len(jrows) == 1 + 4 + 1
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:2] == j[:2]
        for a, b in zip(t[2:], j[2:]):
            assert float(a) == pytest.approx(float(b), abs=2e-4)
    assert tev.main(argv + ["--range", "3"], device="cpu") == 1  # nothing scored


# --------------------------------------------------------------------- gen_db_reg
def _fake_batch(calls):
    """A txt2img main writing `--n_samples` numbered PNGs and a grid."""
    def main(argv):
        calls.append(list(argv))
        out, n = argv[argv.index("--out") + 1], int(argv[argv.index("--n_samples") + 1])
        seed = int(argv[argv.index("--seed") + 1])
        os.makedirs(out, exist_ok=True)
        for i in range(n):
            png.write(os.path.join(out, f"{i:05}.png"), np.full((4, 4, 3), seed * 10 + i,
                                                                np.uint8))
        png.write(os.path.join(out, "grid.png"), np.zeros((4, 4, 3), np.uint8))
        return 0
    return main


def test_gen_db_reg_equals_jax(jax_scripts, tmp_path, capsys, monkeypatch):
    jdb = jax_scripts("gen_db_reg")
    jt2i = sys.modules["txt2img"]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jt2i, "parse_args", lambda argv: argv)
    monkeypatch.setattr(jt2i, "main", _fake_batch(jcalls))
    monkeypatch.setattr(tt2i, "main", lambda argv, device=None: _fake_batch(tcalls)(argv))
    common = ["--class_prompt", "a photo of a person", "--num_images", "5", "--n_samples", "2",
              "--seed", "4", "--steps", "3", "--ckpt", "sd.ckpt", "--tiny"]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    assert jdb.main(common + ["--out", str(jout)]) == 0
    jprint = _outputs(capsys, jout)
    assert tdb.main(common + ["--out", str(tout)], device="cpu") == 0
    assert _outputs(capsys, tout) == jprint
    norm = lambda calls, root: [[a.replace(str(root), "<out>") for a in c] for c in calls]
    assert norm(tcalls, tout) == norm(jcalls, jout)
    assert [c[c.index("--n_samples") + 1] for c in tcalls] == ["2", "2", "1"]
    jfiles = sorted(f for f in os.listdir(jout) if f.startswith("reg_"))
    tfiles = sorted(f for f in os.listdir(tout) if f.startswith("reg_"))
    assert [f.replace(".jpg", ".png") for f in jfiles] == tfiles  # PNGs named .png
    # the same images (JAX moved the PNG bytes under a .jpg name), in the
    # port in batch order (JAX walks the batch folders in the file system's)
    assert sorted((tout / f).read_bytes() for f in tfiles) == \
        sorted((jout / f).read_bytes() for f in jfiles)
    assert [int(png.read(str(tout / f))[0, 0, 0]) for f in tfiles] == [40, 41, 50, 51, 60]


def test_gen_db_reg_end_to_end(tmp_path, capsys):
    out = tmp_path / "reg"
    argv = ["--class_prompt", "a photo of a person", "--out", str(out), "--num_images", "3",
            "--n_samples", "2", "--steps", "2", "--size", "32", "--tiny"]
    assert tdb.main(argv, device="cpu") == 0
    assert "wrote 3 class-regularization images" in capsys.readouterr().out
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == \
        ["reg_00000.png", "reg_00001.png", "reg_00002.png"]
    first = tdb.batch_argvs(tdb.parse_args(argv))[0]
    check = tmp_path / "check"
    first[first.index("--out") + 1] = str(check)
    assert tt2i.main(first, device="cpu") == 0
    for i in range(2):
        assert np.array_equal(png.read(str(out / f"reg_{i:05}.png")),
                              png.read(str(check / f"{i:05}.png")))
    subject = tmp_path / "subject"
    subject.mkdir()
    png.write(str(subject / "0.png"), np.zeros((32, 32, 3), np.uint8))
    ds = DreamBoothDataset(str(subject), str(out), size=32, seed=0)
    assert len(ds.reg_paths) == 3
    _, reg = ds.draw_pair()
    assert reg["image"].shape == (32, 32, 3) and reg["caption"] == "a photo of a person"


# ------------------------------------------------------------------ zero_shot_test
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
CLIP_KW = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=77, num_extra_tokens=4)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _face_fn(img):
    v = np.random.default_rng(int(img.sum())).standard_normal(512)
    return (v / np.linalg.norm(v)).astype(np.float32)


@pytest.fixture(scope="module")
def zs_models():
    """JAX's pipeline and the zero-shot script's seeded params (PRNGKey 3/4/5 at
    its --tiny widths), and the port's models holding the same weights."""
    jtok, tok = JHashTokenizer(), HashTokenizer()
    jp = JPipeline.from_random(jax.random.PRNGKey(1), jtok, JUNetConfig(**UNET_KW),
                               JVAEConfig(**VAE_KW), jct.CLIPTextConfig(**CLIP_KW))
    clip = tct.CLIPTextEncoder(tct.CLIPTextConfig(**CLIP_KW))
    clip.load_state_dict(from_jax.clip_state_dict_from_jax(_tree(jp.clip_params)), strict=True)
    unet = UNetModel(UNetConfig(**UNET_KW))
    unet.load_state_dict(from_jax.unet_state_dict_from_jax(_tree(jp.unet_params)), strict=True)
    vae = AutoencoderKL(VAEConfig(**VAE_KW))
    vae.load_state_dict(from_jax.vae_state_dict_from_jax(_tree(jp.vae_params)), strict=True)
    tp = StableDiffusionPipeline(tok, clip, unet, vae)

    D = 64
    vis_cfg = jcv.CLIPVisionConfig.tiny(hidden_size=48)
    vparams = _tree(jcv.CLIPVisionEncoder(vis_cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, vis_cfg.image_size, vis_cfg.image_size, 3)))
        ["params"])
    txt_cfg = jct.CLIPTextConfig.tiny(vocab_size=jtok.vocab_size, hidden_size=D, num_layers=2,
                                      max_position_embeddings=77)
    arc_params = _tree(jct.CLIPTextEncoder(txt_cfg).init(
        jax.random.PRNGKey(4), input_ids=jnp.zeros((1, 77), jnp.int32))["params"])
    jgen = JGen(placeholder_is_bg=False, num_out_layers=16, num_out_embs_per_layer=16,
                output_dim=D, proj_cfg=txt_cfg, pad_token_id=jtok.eos_id,
                zs_extra_words_scale=0.5)
    gparams = _tree(jgen.init(jax.random.PRNGKey(5), None, None, jnp.zeros((1, 16, D)),
                              inverse_template_ids=jnp.asarray(
                                  jtok([INVERSE_TEMPLATE], max_length=77)))["params"])
    opt = tzs.parse_args(["--ref_images", "x", "--tiny"])
    builds = tzs.model_builds(opt, tok, D)
    vision = builds["vision"]()
    vision.load_state_dict(from_jax.vision_state_dict_from_jax(vparams), strict=True)
    arc = builds["arc2face"]()
    arc.load_state_dict(from_jax.clip_state_dict_from_jax(arc_params), strict=True)
    gen = from_jax.load_subj_basis_generator_from_jax(builds["generator"](), gparams)
    return jp, dict(pipe=tp, tok=tok, vision=vision.eval(), arc2face=arc.eval(),
                    generator=gen.eval())


def _seeded(monkeypatch, pipe, record):
    real = pipe.generate

    def generate(prompts, seed=0, height=512, width=512, **kw):
        x_T = np.random.default_rng(seed).standard_normal(
            (len(prompts), height // 2, width // 2, 4)).astype(np.float32)
        out = real(prompts, seed=seed, height=height, width=width, x_T=x_T, **kw)
        record.append(np.asarray(out))
        return out

    monkeypatch.setattr(pipe, "generate", generate)


_STAT = re.compile(r"std=(-?\d+\.\d+)|norm=(-?\d+\.\d+)")


@pytest.mark.parametrize("arm", ["personalized", "--apply_arc2face_embs",
                                 "--apply_arc2face_inverse_embs"])
def test_zero_shot_test_arms_equal_jax(jax_scripts, zs_models, tmp_path, capsys, monkeypatch,
                                       arm):
    jzs_script = jax_scripts("zero_shot_test")
    jp, models = zs_models
    refs = []
    g = np.random.default_rng(8)
    for i, shape in enumerate([(40, 32), (30, 30)]):
        refs.append(str(tmp_path / f"ref{i}.png"))
        png.write(refs[-1], g.integers(0, 256, shape + (3,), dtype=np.uint8))
    argv = ["--ref_images", *refs, "--tiny", "--steps", "2", "--size", "32", "--n_samples", "1",
            "--seed", "3", "--prompt", "a photo of z, , in the snow"]
    if arm != "personalized":
        argv.append(arm)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jopt = tzs.parse_args(argv + ["--out", str(jout)])
    jimgs, timgs = [], []
    monkeypatch.setattr(sys.modules["txt2img"], "build_pipeline",
                        lambda opt: (jp, jp.tokenizer))
    monkeypatch.setattr(sys.modules["filter_faces"], "default_face_app",
                        lambda: SimpleNamespace(embed_image=_face_fn))
    _seeded(monkeypatch, jp, jimgs)
    _seeded(monkeypatch, models["pipe"], timgs)
    assert jzs_script.main(jopt) == 0
    jprint = capsys.readouterr().out
    stats = tzs.run(tzs.parse_args(argv + ["--out", str(tout)]), models, _face_fn)
    tprint = capsys.readouterr().out
    jnums = [float(a or b) for a, b in _STAT.findall(jprint)]
    tnums = [float(a or b) for a, b in _STAT.findall(tprint)]
    assert len(tnums) == len(jnums) == 3
    for a, b in zip(tnums, jnums):
        assert a == pytest.approx(b, abs=1.5e-4)
    assert stats["clip_std"] == pytest.approx(jnums[0], abs=5e-5 + 1e-6)
    strip = lambda s: _STAT.sub("", s).replace(str(jout), "<out>").replace(str(tout), "<out>")
    assert strip(tprint) == strip(jprint)
    assert np.abs(timgs[0].astype(int) - jimgs[0].astype(int)).max() <= 1
    assert np.array_equal(png.read(str(tout / "00000.png")), timgs[0][0])


def test_zero_shot_test_refuses_a_narrow_inverse_context(jax_scripts, zs_models, tmp_path,
                                                         monkeypatch):
    jzs_script = jax_scripts("zero_shot_test")
    jp, models = zs_models
    ref = str(tmp_path / "ref.png")
    png.write(ref, np.full((30, 30, 3), 90, np.uint8))
    argv = ["--ref_images", ref, "--tiny", "--apply_arc2face_inverse_embs",
            "--zs_arc2face_inverse_prompt_embs_inf_type", "b_core_e", "--out", str(tmp_path)]
    monkeypatch.setattr(sys.modules["txt2img"], "build_pipeline",
                        lambda opt: (jp, jp.tokenizer))
    monkeypatch.setattr(sys.modules["filter_faces"], "default_face_app",
                        lambda: SimpleNamespace(embed_image=_face_fn))
    with pytest.raises(SystemExit, match="77 tokens"):
        jzs_script.main(tzs.parse_args(argv))
    with pytest.raises(SystemExit, match="77 tokens"):
        tzs.run(tzs.parse_args(argv), models, _face_fn)
