"""Offline batch evaluator of samples already generated (counterpart of
`scripts/evaluate_subjects.py`):

    python -m adaface_tpu_torch.evaluate_subjects --gt_dir subjects-dreambench \\
        --samples_dir outputs/eval --subject_file configs/info-subjects-example.sh

For each selected subject of a fish-syntax info file it reads the prompt
manifest (`<samples_dir>/<subject>-prompts.tsv`, as `gen_subjects_and_eval`
writes it, or the reference's tab-separated `-prompts.txt`), scores each
prompt's sample folder against the subject's ground-truth folder (CLIP-I,
CLIP-T against the manifest's original prompt, DINO; a repeated original
prompt is scored once), and prints per-subject and all-subject means; a
subject without a scorable row is skipped. `--out_csv` writes the rows and
the mean. Scorer weights come from `CLIP_SCORER_PT` / `DINO_VITS16_PT`
(random tiny towers without them). It never generates.

It runs on the CUDA card; `--device cpu` (or `main(..., device="cpu")`)
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--gt_dir", default="subjects-dreambench",
                   help="root of per-subject ground-truth image folders")
    p.add_argument("--samples_dir", default="samples-dbeval-ada",
                   help="root of generated samples and *-prompts.tsv manifests")
    p.add_argument("--subject_file", default="configs/info-subjects-example.sh",
                   help="evaluation/info-*.sh style fish-syntax file")
    p.add_argument("--range", dest="range_str", default=None,
                   help="subject range like '1-30' (1-offset, inclusive)")
    p.add_argument("--selset", action="store_true",
                   help="evaluate only the info file's sel_set subset")
    p.add_argument("--skipselset", action="store_true",
                   help="evaluate all subjects except the sel_set subset")
    p.add_argument("--num_samples", type=int, default=4,
                   help="samples per prompt folder to score")
    p.add_argument("--gt_self_compare", action="store_true",
                   help="score each subject's gt folder against itself")
    p.add_argument("--out_csv", default=None, help="per-(subject, prompt) scores CSV")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def read_prompt_manifest(samples_dir: str, subject: str):
    """Rows of (indiv_subdir, prompt, orig_prompt) of the subject's manifest:
    `-prompts.tsv` or the reference's `-prompts.txt` (n_repeat,
    indiv_subdir, prompt[, orig_prompt], tab-separated)."""
    for ext in (".tsv", ".txt"):
        path = os.path.join(samples_dir, subject + "-prompts" + ext)
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(
            f"no {subject}-prompts.tsv/.txt under {samples_dir} "
            "(generate with adaface_tpu_torch.gen_subjects_and_eval first)")
    rows = []
    with open(path) as f:
        for row in csv.reader(f, delimiter="\t"):
            if not row:
                continue
            rows.append((row[1], row[2], row[3] if len(row) > 3 else row[2]))
    return rows


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Score as the options say; 1 when no subject was scored. `argv`
    defaults to the command line; `device` overrides `--device`."""
    from adaface_tpu_torch.evaluation.eval_utils import (compare_folders, parse_range_str,
                                                         parse_subject_file)
    from adaface_tpu_torch.evaluation.scorers import init_evaluators

    opt = parse_args(argv)
    clip_evator, dino_evator = init_evaluators(
        device=device if device is not None else opt.device)
    subj_info, _ = parse_subject_file(opt.subject_file)
    subjects = subj_info["subjects"]
    sel_set = subj_info["sel_set"]

    indices = sel_set if opt.selset else list(range(len(subjects)))
    range_indices = parse_range_str(opt.range_str)
    if range_indices is not None:
        indices = [indices[i] for i in range_indices]

    csv_rows = []
    per_subject = []  # (subject, mean_img, mean_text, mean_dino)
    for i, subject_idx in enumerate(indices):
        if opt.skipselset and subject_idx in sel_set:
            continue
        subject = subjects[subject_idx]
        gt_dir = os.path.join(opt.gt_dir, subject)
        print(f"{i + 1}/{len(indices)}  {subject}")

        sims_img, sims_text, sims_dino = [], [], []
        seen = set()
        manifest = read_prompt_manifest(opt.samples_dir, subject)
        for pi, (indiv_subdir, prompt, orig_prompt) in enumerate(manifest):
            if orig_prompt in seen:  # the reference scores a repeated prompt once
                continue
            seen.add(orig_prompt)
            print(f"{pi + 1}/{len(manifest)} Prompt: {orig_prompt}")
            gen_dir = os.path.join(opt.samples_dir, indiv_subdir)
            ci, ct, dn = compare_folders(clip_evator, dino_evator, gen_dir, gt_dir,
                                         orig_prompt, opt.num_samples, opt.gt_self_compare)
            sims_img.append(ci)
            sims_text.append(ct)
            sims_dino.append(dn)
            csv_rows.append([subject, orig_prompt, f"{ci:.4f}", f"{ct:.4f}", f"{dn:.4f}"])

        if not sims_img:  # no scorable rows: skip rather than NaN-poison
            print(f"no scorable prompts for {subject}; skipping\n")
            continue
        mi, mt, md = (float(np.mean(sims_img)), float(np.mean(sims_text)),
                      float(np.mean(sims_dino)))
        per_subject.append((subject, mi, mt, md))
        print(f"Mean image/text/dino sim: {mi:.3f} {mt:.3f} {md:.3f}")
        run = np.mean([[s[1], s[2], s[3]] for s in per_subject], axis=0)
        print("All subjects mean image/text/dino sim: "
              f"{run[0]:.3f} {run[1]:.3f} {run[2]:.3f}\n")

    if not per_subject:
        print("no subjects evaluated")
        return 1

    for k, (subject, mi, mt, md) in enumerate(per_subject):
        print(f"{k + 1} {subject}: {mi:.3f} {mt:.3f} {md:.3f}")
    final = np.mean([[s[1], s[2], s[3]] for s in per_subject], axis=0)
    print(f"All subjects: {final[0]:.3f} {final[1]:.3f} {final[2]:.3f}")

    if opt.out_csv:
        with open(opt.out_csv, "w") as f:
            w = csv.writer(f)
            w.writerow(["subject", "prompt", "clip_i", "clip_t", "dino"])
            w.writerows(csv_rows)
            w.writerow(["MEAN", "", *[f"{v:.4f}" for v in final]])
        print(f"wrote {len(csv_rows)} rows -> {opt.out_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
