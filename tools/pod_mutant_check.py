#!/usr/bin/env python3
"""Broken copies of the pod tooling, each against the unchanged tests and
phase 8e's gates; prints one ``MUTANT {...}`` line a copy and part.

Each copy is ``src/`` copied into a temporary directory with one textual
substitution:
  expert_fallback  ``shardings.spec_for_leaf`` without its expert-count
                   rule: experts go over ``model`` whatever their count
                   (granite's 40 over 16);
  mean_of_means    the data-parallel step divides each rank's nll by its
                   own valid-label count times the ranks: the mean of the
                   ranks' means;
  filter_keeps     ``shardings._filter`` keeps an axis that does not divide
                   its dimension.

``--part tests`` (the CPU, with the JAX reference installed) runs
``tests/test_torch_shardings.py`` and ``tests/test_torch_dryrun.py`` on
each copy and prints their counts.  ``--part card`` (an NVIDIA GPU) runs
the parts of ``chip_smoke.py``'s phase 8e that each copy is meant to
break, each in a fresh process on the copy: expert_fallback (a)'s
granite-moe-3b-a800m train_4k; mean_of_means (c); filter_keeps (b), whose
plan holds granite-moe-3b-a800m's embedding (its vocabulary, 49155, does
not divide ``model`` 2), and (a)'s granite-moe-3b-a800m train_4k (nor
``model`` 16).

Usage, from the repository root:
  PYTHONPATH=src python tools/pod_mutant_check.py --part tests
  python3 tools/pod_mutant_check.py --part card    # one NVIDIA GPU
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MUTANTS = {
    "expert_fallback": (
        "launch/shardings.py",
        "expert_par = model_n <= 1 or (e_dim % model_n == 0)",
        "expert_par = True"),
    "mean_of_means": (
        "training/steps.py",
        "counts = mesh.all_reduce(counts, axes)",
        "counts = counts * n_ranks"),
    "filter_keeps": (
        "launch/shardings.py",
        "if i >= len(shape) or shape[i] % _axis_size(mesh, entry) != 0:",
        "if i >= len(shape):"),
}
CARD_PARTS = {"expert_fallback": ("a",), "mean_of_means": ("c",),
              "filter_keeps": ("b", "a")}
TESTS = ("tests/test_torch_shardings.py", "tests/test_torch_dryrun.py")

# one part of phase 8e on the copy at sys.argv[1]; prints its outcome
_CARD_PART = """
import json, re, sys, traceback
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke
if __name__ == "__main__":
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    part = sys.argv[3]
    out = {"part": part}
    try:
        if part == "a":
            chip_smoke.POD_DRYRUN_COMBOS = (("granite-moe-3b-a800m",
                                             "train_4k"),)
            runs = chip_smoke.start_dryruns()
            try:
                out["records"] = chip_smoke.finish_dryruns(runs)
            finally:
                chip_smoke.stop_dryruns(runs)
        elif part == "b":
            out["record"] = chip_smoke.pod_plan_part(torch)
        else:
            out["record"] = chip_smoke.pod_dp_part(torch)
        out["caught"] = False
    except chip_smoke.SmokeFailure as e:
        out["caught"], out["failure"] = True, str(e)[:600]
    except Exception as e:
        # a world's failure holds every rank's traceback: keep their error
        # lines (the first rank's cause, then its peers' lost connections)
        text = type(e).__name__ + ": " + str(e)
        errors = re.findall(r"^\\w*(?:Error|Exception): .*$", text, re.M)
        out["caught"] = True
        out["failure"] = ("; ".join(dict.fromkeys(errors)) or text)[-600:]
    print("PART " + json.dumps(out, default=str))
"""


def make_copy(name: str, tmp: Path) -> Path:
    """``src/`` with ``name``'s substitution, under ``tmp``; returns the
    copy's ``src``."""
    path, old, new = MUTANTS[name]
    src = tmp / name / "src"
    shutil.copytree(ROOT / "src", src,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    target = src / "repro_torch" / path
    text = target.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {old!r} is not in {target} once")
    target.write_text(text.replace(old, new))
    return src


def run_tests(name: str, src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         *TESTS], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=1200)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    failed = re.findall(r"^FAILED (\S+)", proc.stdout, re.M)
    return {"mutant": name, "part": "tests", "exit": proc.returncode,
            "summary": tail, "failed": failed,
            "caught": proc.returncode != 0}


def run_card(name: str, src: Path, part: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _CARD_PART, str(src), str(ROOT), part],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("PART ")), None)
    if line is None:
        return {"mutant": name, "part": part, "caught": None,
                "exit": proc.returncode, "stderr": proc.stderr[-2000:]}
    return {"mutant": name, **json.loads(line[len("PART "):])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("tests", "card"), required=True)
    ap.add_argument("--mutant", choices=list(MUTANTS), action="append")
    args = ap.parse_args(argv)
    missed = []
    with tempfile.TemporaryDirectory(prefix="pod_mutants_") as tmp:
        for name in args.mutant or list(MUTANTS):
            src = make_copy(name, Path(tmp))
            if args.part == "tests":
                results = [run_tests(name, src)]
            else:
                results = [run_card(name, src, p) for p in CARD_PARTS[name]]
            for res in results:
                print("MUTANT " + json.dumps(res, default=str), flush=True)
                if not res["caught"]:
                    missed.append((name, res["part"]))
    if missed:
        print(f"not caught: {missed}", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
