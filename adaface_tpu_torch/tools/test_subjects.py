"""Per-subject batch generation and scoring (counterpart of
`scripts/test_subjects.sh`):

    python -m adaface_tpu_torch.tools.test_subjects INFO DATA_ROOT LOGROOT \\
        OUTROOT [RANGE] [EXTRA...]

INFO and RANGE as in `tools/train_subjects.py`. For each subject in turn it
prints `=== generating SUBJ ===` and calls `adaface_tpu_torch.txt2img.main(
["--embedding_paths", LOGROOT/SUBJ/embeddings_last.npz, "--prompt", "a
photo of a z", "--compare_with", DATA_ROOT/SUBJ, "--out", OUTROOT/SUBJ,
*EXTRA])` in-process (EXTRA e.g. `--ckpt sd-v1-5.safetensors --steps 50`),
on the card unless `main(..., device="cpu")` or `--device cpu` in EXTRA.
Each run builds its own pipeline; the card's cached memory is released
between subjects; the first run that returns non-zero stops the loop and its
code is returned, as the script's `set -e` does.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from adaface_tpu_torch.tools.train_subjects import for_each_subject, positional


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    from adaface_tpu_torch import txt2img

    argv = list(sys.argv[1:] if argv is None else argv)
    got = positional(argv, [("INFO", "info file"), ("DATA_ROOT", "data root"),
                            ("LOGROOT", "log root"), ("OUTROOT", "out root")],
                     "test_subjects")
    if got is None:
        return 2
    (info, data_root, logroot, outroot), range_str, extra = got
    return for_each_subject(
        "test_subjects", "generating", info, range_str,
        lambda subj: txt2img.main([
            "--embedding_paths", f"{logroot}/{subj}/embeddings_last.npz",
            "--prompt", "a photo of a z", "--compare_with", f"{data_root}/{subj}",
            "--out", f"{outroot}/{subj}", *extra], device=device))


if __name__ == "__main__":
    sys.exit(main())
