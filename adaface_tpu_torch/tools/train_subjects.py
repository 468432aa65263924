"""Per-subject batch training (counterpart of `scripts/train_subjects.sh`):

    python -m adaface_tpu_torch.tools.train_subjects INFO DATA_ROOT LOGROOT \\
        [RANGE] [EXTRA...]

INFO is a fish-syntax subject file (`set -g subjects ...`, read by
`evaluation/eval_utils.parse_subject_file`); RANGE selects subjects 1-offset,
like "1-5,8" (empty or absent: the file's `sel_set`, else all of them).
For each subject in turn it prints `=== training SUBJ ===` and calls
`adaface_tpu_torch.train.main(["--data_root", DATA_ROOT/SUBJ, "--logdir",
LOGROOT/SUBJ, *EXTRA])` in-process, on the card unless `main(...,
device="cpu")`. Each run builds its own models, as the shell loop's
processes do, and the card's cached memory is released between subjects.
As under the script's `set -e`, the first run that returns non-zero stops
the loop and its code is returned. The helpers here serve
`tools/test_subjects.py` too.
"""

from __future__ import annotations

import gc
import sys
from typing import Callable, List, Optional, Sequence


def positional(argv: Sequence[str], names, prog: str):
    """(the required arguments, RANGE, EXTRA) as the script's `${n:?msg}`,
    `${n+1:-}` and `shift` take them from argv; None (after the shell's
    message) where a required one is missing or empty."""
    for i, (name, msg) in enumerate(names):
        if len(argv) <= i or not argv[i]:
            print(f"{prog}: {name}: {msg}", file=sys.stderr)
            return None
    n = len(names)
    return list(argv[:n]), (argv[n] if len(argv) > n else ""), list(argv[n + 1:])


def subject_names(info_path: str, range_str: str) -> List[str]:
    """The subjects that the scripts' inline Python prints, split on
    whitespace as the shell's `for SUBJ in $SUBJECTS` splits them."""
    from adaface_tpu_torch.evaluation.eval_utils import parse_range_str, parse_subject_file

    info, _ = parse_subject_file(info_path)
    sel = parse_range_str(range_str or None) or info["sel_set"]
    return " ".join(info["subjects"][i] for i in sel).split()


def _exit_code(run: Callable[[], Optional[int]]) -> int:
    """A run's return code, a `SystemExit` from it read as the process's
    exit status."""
    try:
        rc = run()
    except SystemExit as e:
        rc = e.code
    if rc is None:
        return 0
    if not isinstance(rc, int):
        print(rc, file=sys.stderr)
        return 1
    return rc


def release_card():
    """Drop the last subject's models and return the card's cached memory."""
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def for_each_subject(prog: str, verb: str, info: str, range_str: str,
                     run: Callable[[str], Optional[int]]) -> int:
    try:
        subjects = subject_names(info, range_str)
    except (OSError, ValueError, IndexError) as e:
        print(f"{prog}: {info}: {e}", file=sys.stderr)
        return 1
    for subj in subjects:
        print(f"=== {verb} {subj} ===", flush=True)
        rc = _exit_code(lambda: run(subj))
        release_card()
        if rc != 0:
            return rc
    return 0


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    from adaface_tpu_torch import train

    argv = list(sys.argv[1:] if argv is None else argv)
    got = positional(argv, [("INFO", "info file"), ("DATA_ROOT", "data root"),
                            ("LOGROOT", "log root")], "train_subjects")
    if got is None:
        return 2
    (info, data_root, logroot), range_str, extra = got
    return for_each_subject(
        "train_subjects", "training", info, range_str,
        lambda subj: train.main(["--data_root", f"{data_root}/{subj}",
                                 "--logdir", f"{logroot}/{subj}", *extra], device=device))


if __name__ == "__main__":
    sys.exit(main())
