"""The per-subject batch drivers `adaface_tpu_torch.tools.train_subjects` and
`test_subjects` against the shell scripts they port
(`scripts/train_subjects.sh`, `scripts/test_subjects.sh`): the argv lists
each hands to `train.main` / `txt2img.main` equal the ones the scripts hand
to `python scripts/train.py` / `scripts/txt2img.py` (recorded by a stub
`python` first on PATH, which runs the scripts' inline `python -` with the
real interpreter), with and without RANGE and EXTRA; the printed lines; a
failing subject stops both loops with its code; and a `--tiny` CPU run trains
and tests two subjects of JPEGs with PIL blocked."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from adaface_tpu_torch.tools import test_subjects, train_subjects

REPO = Path(__file__).resolve().parent.parent
INFO = str(REPO / "configs" / "info-subjects-example.sh")
STUB = f"""#!{sys.executable}
import json, os, sys
if sys.argv[1:2] == ["-"]:
    os.execv({sys.executable!r}, [{sys.executable!r}] + sys.argv[1:])
with open(os.environ["STUB_RECORD"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
fail, _, code = os.environ.get("STUB_FAIL", ":").partition(":")
sys.exit(int(code) if fail and any(fail in a for a in sys.argv) else 0)
"""


def _shell(tmp_path, script, args, fail=""):
    """(exit code, stdout, argv lists without the script's path) of
    `sh scripts/<script> args` under the stub python."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text(STUB)
    stub.chmod(0o755)
    record = tmp_path / "record.jsonl"
    record.write_text("")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}", STUB_RECORD=str(record),
               STUB_FAIL=fail, JAX_PLATFORMS="cpu")
    r = subprocess.run(["sh", f"scripts/{script}", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    calls = [json.loads(line) for line in record.read_text().splitlines()]
    return r.returncode, r.stdout, [c[1:] for c in calls], [c[0] for c in calls]


def _port(monkeypatch, capsys, module, target, args, fail=None, raise_exit=False):
    """(return code, stdout, argv lists) of the port's driver with the
    entry point replaced by a recorder."""
    calls = []

    def fake(argv, *, device=None):
        calls.append(list(argv))
        if fail and any(fail[0] in a for a in argv):
            if raise_exit:
                raise SystemExit(fail[1])
            return fail[1]
        return 0

    monkeypatch.setattr(target, "main", fake)
    capsys.readouterr()
    rc = module.main(list(args), device="cpu")
    return rc, capsys.readouterr().out, calls


CASES = {"all": ("", []), "range": ("2-3", []),
         "extra": ("", ["--max_steps", "5", "--bf16"]),
         "range_and_extra": ("1,3", ["--size", "256", "--seed", "7"])}


def _args(fixed, range_str, extra):
    return fixed + ([range_str] if range_str or extra else []) + extra


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_subjects_argv_equals_the_script(case, tmp_path, monkeypatch, capsys):
    from adaface_tpu_torch import train

    args = _args([INFO, "data", "logs"], *CASES[case])
    rc, out, calls, scripts = _shell(tmp_path, "train_subjects.sh", args)
    assert rc == 0 and set(scripts) == {"scripts/train.py"} and calls
    got_rc, got_out, got = _port(monkeypatch, capsys, train_subjects, train, args)
    assert (got_rc, got_out, got) == (rc, out, calls)
    assert got[0][:4] == ["--data_root", f"data/{out.split()[2]}", "--logdir",
                          f"logs/{out.split()[2]}"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_test_subjects_argv_equals_the_script(case, tmp_path, monkeypatch, capsys):
    from adaface_tpu_torch import txt2img

    range_str, extra = CASES[case]
    args = _args([INFO, "data", "logs", "out"], range_str, extra + ["--ckpt", "sd.safetensors"])
    rc, out, calls, scripts = _shell(tmp_path, "test_subjects.sh", args)
    assert rc == 0 and set(scripts) == {"scripts/txt2img.py"} and calls
    got_rc, got_out, got = _port(monkeypatch, capsys, test_subjects, txt2img, args)
    assert (got_rc, got_out, got) == (rc, out, calls)
    assert "=== generating" in got_out


@pytest.mark.parametrize("raise_exit", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("driver", ["train", "test"])
def test_failing_subject_stops_the_loop(driver, raise_exit, tmp_path, monkeypatch, capsys):
    from adaface_tpu_torch import train, txt2img

    module, target, script, fixed = {
        "train": (train_subjects, train, "train_subjects.sh", [INFO, "data", "logs"]),
        "test": (test_subjects, txt2img, "test_subjects.sh", [INFO, "data", "logs", "out"]),
    }[driver]
    rc, out, calls, _ = _shell(tmp_path, script, fixed, fail="bob:3")
    got_rc, got_out, got = _port(monkeypatch, capsys, module, target, fixed,
                                 fail=("bob", 3), raise_exit=raise_exit)
    assert rc == got_rc == 3
    assert got_out == out and got == calls and len(got) == 2  # alice, bob; not rex
    assert "rex" not in got_out


def test_missing_arguments_exit_as_the_script(tmp_path, capsys):
    for module, script, args in ((train_subjects, "train_subjects.sh", [INFO, "data"]),
                                 (test_subjects, "test_subjects.sh", [INFO, "data", "logs", ""])):
        rc, _, calls, _ = _shell(tmp_path, script, args)
        assert module.main(args, device="cpu") == rc == 2 and calls == []
        assert "root" in capsys.readouterr().err


def test_tiny_run_of_two_jpeg_subjects_without_pil(tmp_path, monkeypatch):
    from make_torch_jpeg_fixtures import encode, make

    data = tmp_path / "data"
    for s, subj in enumerate(("alice", "bob")):
        (data / subj).mkdir(parents=True)
        for i in range(2):
            (data / subj / f"{i}.jpg").write_bytes(
                encode(make("smooth" if i else "noise", 40, 48, False, 10 * s + i),
                       quality=90, progressive=bool(s)))
    info = tmp_path / "info.sh"
    info.write_text("set -g subjects alice bob\nset -g class_names woman man\n"
                    "set -g cls_delta_strings woman man\nset -g data_folder data\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    logs, out = tmp_path / "logs", tmp_path / "out"
    rc = train_subjects.main([str(info), str(data), str(logs), "", "--tiny", "--size", "32",
                              "--max_steps", "2", "--base",
                              str(REPO / "configs" / "finetune-ti.yaml")], device="cpu")
    assert rc == 0
    for subj in ("alice", "bob"):
        z = np.load(logs / subj / "embeddings_last.npz")
        assert len(z.files) > 0
    rc = test_subjects.main([str(info), str(data), str(logs), str(out), "", "--tiny",
                             "--device", "cpu", "--steps", "2", "--size", "32",
                             "--n_samples", "1"], device="cpu")
    assert rc == 0
    for subj in ("alice", "bob"):
        rows = (out / subj / "scores.csv").read_text().splitlines()
        assert len(rows) == 1 and rows[0].startswith("a photo of a z")
        assert (out / subj / "00000.png").exists()
