"""Batch subject generation and evaluation (counterpart of
`scripts/gen_subjects_and_eval.py`):

    python -m adaface_tpu_torch.gen_subjects_and_eval \\
        --subject_file configs/info-subjects-example.sh --logdir logs \\
        --ckpt sd-v1-5.ckpt --outdir outputs/eval

For each selected subject of a fish-syntax info file it writes the prompt
manifest `<outdir>/<subject>-prompts.tsv` (rows `1, pNN, prompt,
class prompt` of the DreamBench or community set), finds the subject's
newest embeddings under `<logdir>/*<subject>*/` (`embeddings_*.npz` or
`.pt` by modification time, or those of `--ckpt_iter`), generates through
the port's `txt2img.main` in-process, scored against the subject's
ground-truth folder (`--compare_with`; `--calc_face_sim` for subjects the
info file marks `are_faces`), and gathers every subject's `scores.csv` rows
into `<outdir>/all_scores.csv` with a `MEAN` row. `--dryrun` prints each
subject's txt2img argv; `--gen_prompt_set_only` writes the manifests alone.

It runs on the CUDA card; `--device cpu` (or `main(..., device="cpu")`)
runs it on the CPU. Samples are PNGs (the port's txt2img). `--num_devices`
/ `--tp` other than 1 are forwarded, and txt2img exits naming ROADMAP queue
1 item 13.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--subject_file", required=True,
                   help="evaluation/info-*.sh style fish-syntax file")
    p.add_argument("--data_root", default=None,
                   help="overrides the info file's data_folder")
    p.add_argument("--logdir", default="logs", help="root of per-subject training runs")
    p.add_argument("--outdir", default="outputs/eval")
    p.add_argument("--range", dest="range_str", default=None,
                   help="subject range like '1-5,8' (1-offset)")
    p.add_argument("--prompt_set", choices=("dreambench", "community", "all"),
                   default="dreambench")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--num_devices", type=int, default=1,
                   help="forwarded to txt2img (one card in the port)")
    p.add_argument("--tp", type=int, default=1, help="forwarded to txt2img (1 in the port)")
    p.add_argument("--z_prefix", default="")
    p.add_argument("--z_suffix_type", default=None,
                   help="'' | class_name | cls_delta_string | literal text (default: "
                        "class_name for non-human broad classes)")
    p.add_argument("--extra_z_suffix", default="",
                   help="extra suffix after the subject token")
    p.add_argument("--prompt_prefix", default="")
    p.add_argument("--prompt_suffix", default="", help="appended as ', <suffix>'")
    p.add_argument("--include_bg_string", action="store_true",
                   help="append 'with background y, ...' to prompts")
    p.add_argument("--background_string", default="y")
    p.add_argument("--num_vectors_per_bg_token", type=int, default=4)
    p.add_argument("--method", choices=("ada", "ti", "static", "db"), default="ada",
                   help="evaluated method; db defaults z_suffix_type to cls_delta_string")
    p.add_argument("--ckpt_iter", type=int, default=None,
                   help="pick embeddings at this step instead of the newest")
    p.add_argument("--selset", action="store_true",
                   help="evaluate only the info file's sel_set")
    p.add_argument("--skipselset", action="store_true",
                   help="skip the info file's sel_set subjects")
    p.add_argument("--gen_prompt_set_only", action="store_true",
                   help="write the prompt TSVs and exit")
    p.add_argument("--dryrun", action="store_true",
                   help="print the per-subject txt2img argv without running")
    p.add_argument("--ckpt", default=None, help="SD v1.x .ckpt or .safetensors")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--max_prompts", type=int, default=-1)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def find_newest_embeddings(logdir: str, subject: str, ckpt_iter=None) -> Optional[str]:
    """The newest `embeddings_*.npz` / `.pt` under `<logdir>/*<subject>*/` by
    modification time; `ckpt_iter` pins a training step (`_<n>.` or
    `gs-<n>.` in the file name)."""
    cands = sorted(
        glob.glob(os.path.join(logdir, f"*{subject}*", "embeddings_*.npz"))
        + glob.glob(os.path.join(logdir, f"*{subject}*", "embeddings_*.pt")),
        key=os.path.getmtime)
    if ckpt_iter is not None:
        pinned = [c for c in cands
                  if f"_{ckpt_iter}." in os.path.basename(c)
                  or f"gs-{ckpt_iter}." in os.path.basename(c)]
        return pinned[-1] if pinned else None
    return cands[-1] if cands else None


def resolve_z_suffix(opt, broad: int, class_name: str, cls_delta: str) -> str:
    """The reference's z-suffix dispatch: db -> the cls_delta string; by
    default '' for humans and animals (broad class 1), the class name
    otherwise; a literal suffix passes through (a leading space added before
    a word)."""
    zst = opt.z_suffix_type
    if zst is None:
        zst = "cls_delta_string" if opt.method == "db" else \
            ("" if broad == 1 else "class_name")
    if zst == "cls_delta_string":
        z_suffix = " " + cls_delta
    elif zst == "class_name":
        z_suffix = " " + class_name
    elif zst == "":
        z_suffix = ""
    else:
        z_suffix = (" " + zst) if zst[0].isalnum() or zst[0] == "_" else zst
    if opt.extra_z_suffix:
        z_suffix += " " + opt.extra_z_suffix + ","
    return z_suffix


def selected_subjects(opt, subjects, sel_set):
    """Indices of the subjects to run: `--selset`, `--range` (else the
    sel_set), `--skipselset`."""
    from adaface_tpu_torch.evaluation.eval_utils import parse_range_str

    if opt.selset:
        sel = list(sel_set)
    else:
        sel = parse_range_str(opt.range_str) or list(sel_set)
    if opt.skipselset:
        base = parse_range_str(opt.range_str) or list(range(len(subjects)))
        sel = [i for i in base if i not in set(sel_set)]
    return sel


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Run as the options say. `argv` defaults to the command line; `device`
    overrides `--device`."""
    from adaface_tpu_torch import txt2img
    from adaface_tpu_torch.evaluation.eval_utils import parse_subject_file
    from adaface_tpu_torch.evaluation.prompt_sets import get_prompt_list

    opt = parse_args(argv)
    device = device if device is not None else opt.device
    subj_info, subj2attr = parse_subject_file(opt.subject_file)
    subjects = subj_info["subjects"]
    sel = selected_subjects(opt, subjects, subj_info["sel_set"])
    data_root = opt.data_root or subj_info["data_folder"][0]

    os.makedirs(opt.outdir, exist_ok=True)
    scores_path = os.path.join(opt.outdir, "all_scores.csv")
    rows = []
    for idx in sel:
        subject = subjects[idx]
        cls_delta = subj2attr.get("cls_delta_strings", {}).get(subject, "person")
        class_name = subj2attr.get("class_names", {}).get(subject, cls_delta)
        broad = subj2attr.get("broad_classes", {}).get(subject, 1)
        z_suffix = resolve_z_suffix(opt, broad, class_name, cls_delta)
        bg = ""
        if opt.include_bg_string and opt.background_string:
            bg = (" with background " + opt.background_string
                  + ", " * (opt.num_vectors_per_bg_token - 1))
        prompts, cls_prompts, _ = get_prompt_list(
            "z", opt.z_prefix, z_suffix, bg, class_name, cls_delta, broad,
            set_name=opt.prompt_set)
        if opt.prompt_prefix:
            prompts = [opt.prompt_prefix + " " + p for p in prompts]
            cls_prompts = [opt.prompt_prefix + " " + p for p in cls_prompts]
        if opt.prompt_suffix:
            prompts = [p + ", " + opt.prompt_suffix for p in prompts]
            cls_prompts = [p + ", " + opt.prompt_suffix for p in cls_prompts]
        if opt.max_prompts > 0:
            prompts, cls_prompts = prompts[:opt.max_prompts], cls_prompts[:opt.max_prompts]
        tsv = os.path.join(opt.outdir, f"{subject}-prompts.tsv")
        with open(tsv, "w") as f:
            w = csv.writer(f, delimiter="\t")
            for pi, prompt in enumerate(prompts):
                w.writerow([1, f"p{pi:02}", prompt, cls_prompts[pi]])

        if opt.gen_prompt_set_only:
            print(f"== {subject}: wrote {tsv}")
            continue
        emb = find_newest_embeddings(opt.logdir, subject, opt.ckpt_iter)
        out = os.path.join(opt.outdir, subject)
        gt = os.path.join(data_root, subject)
        is_face = subj2attr.get("are_faces", {}).get(subject, 1)
        argv2 = ["--from_file", tsv, "--out", out, "--steps", str(opt.steps),
                 "--size", str(opt.size), "--n_samples", str(opt.n_samples)]
        if opt.num_devices != 1 or opt.tp > 1:
            argv2 += ["--num_devices", str(opt.num_devices), "--tp", str(opt.tp)]
        if os.path.isdir(gt):
            argv2 += ["--compare_with", gt, "--class_prompt", cls_prompts[0]]
            if int(is_face):  # face similarity only for are_faces subjects
                argv2 += ["--calc_face_sim"]
        if emb:
            argv2 += ["--embedding_paths", emb]
        if opt.ckpt:
            argv2 += ["--ckpt", opt.ckpt]
        if opt.tiny:
            argv2 += ["--tiny"]
        print(f"== {subject}: emb={emb}")
        if opt.dryrun:
            print("   txt2img " + " ".join(argv2))
            continue
        txt2img.main(argv2, device=device)
        sc = os.path.join(out, "scores.csv")
        if os.path.exists(sc):
            with open(sc) as f:
                for r in csv.reader(f):
                    rows.append([subject] + r)

    if rows:
        with open(scores_path, "w") as f:
            w = csv.writer(f)
            w.writerow(["subject", "prompt", "clip_i", "clip_t", "dino",
                        "face_sim", "face_exceptions", "face_exception_rate"])
            w.writerows(rows)
            mean = np.asarray([[float(x) for x in r[2:5]] for r in rows]).mean(axis=0)
            face = np.asarray([float(r[5]) for r in rows if len(r) > 5])
            exc = np.asarray([float(r[7]) for r in rows if len(r) > 7])
            w.writerow(["MEAN", "", *[f"{m:.4f}" for m in mean],
                        f"{face.mean():.4f}" if len(face) else "",
                        "", f"{exc.mean():.4f}" if len(exc) else ""])
        msg = (f"aggregated {len(rows)} rows -> {scores_path}; mean "
               f"CLIP-I={mean[0]:.4f} CLIP-T={mean[1]:.4f} DINO={mean[2]:.4f}")
        if len(face):
            msg += f" face={face.mean():.4f} exc_rate={exc.mean():.4f}"
        print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
