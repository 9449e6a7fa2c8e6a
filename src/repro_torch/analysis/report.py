"""Render the dry run's JSON (``launch/dryrun.py``) into the roofline table
(the reference's ``analysis/report.py``): the port's keys, the fit against
the H100's 80 GB, and "—" where a ratio is null (the port's dry run has no
HLO FLOPs, so its useful-FLOPs ratio always is)."""

from __future__ import annotations

import json
from pathlib import Path

ARCH_ORDER = [
    "h2o-danube-3-4b", "llava-next-34b", "seamless-m4t-large-v2",
    "xlstm-1.3b", "qwen3-14b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
    "qwen3-8b", "granite-moe-3b-a800m", "gemma-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DEFAULT_DIR = "experiments/dryrun_torch"


def _fmt(x):
    return f"{x:.2e}"


def _ratio(x):
    return "—" if x is None else f"{x:.2f}"


def roofline_table(dryrun_dir=DEFAULT_DIR) -> str:
    rows = []
    rows.append(
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "useful FLOPs ratio | peak GB/dev | fits 80GB | one-line lever |")
    rows.append("|---|---|---|---|---|---|---|---|---|---|")
    levers = {
        "compute_s": "more chips / lower-precision matmuls",
        "memory_s": "fusion + bf16 states; chunked streaming",
        "collective_s": "resharding schedule / overlap collectives with compute",
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            p = Path(dryrun_dir) / f"{arch}__{shape}__single.json"
            if not p.exists():
                rows.append(f"| {arch} | {shape} | — | — | — | MISSING | | | | |")
                continue
            d = json.loads(p.read_text())
            r = d["roofline"]
            rows.append(
                f"| {arch} | {shape} | {_fmt(r['compute_s'])} | "
                f"{_fmt(r['memory_s'])} | {_fmt(r['collective_s'])} | "
                f"{r['dominant'].replace('_s','')} | "
                f"{_ratio(r.get('useful_flops_ratio'))} | "
                f"{d['memory']['peak_estimate_bytes']/1e9:.1f} | "
                f"{'✓' if d['memory']['peak_ok_80gb'] else '✗'} | "
                f"{levers[r['dominant']]} |")
    return "\n".join(rows)


def multipod_summary(dryrun_dir=DEFAULT_DIR) -> str:
    """Check all multi-pod combos ran and summarize the pod-axis cost."""
    lines = ["| arch | shape | multi-pod pass | collective_s 1-pod → 2-pod |",
             "|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            ps = Path(dryrun_dir) / f"{arch}__{shape}__single.json"
            pm = Path(dryrun_dir) / f"{arch}__{shape}__multi.json"
            if not pm.exists():
                lines.append(f"| {arch} | {shape} | MISSING | |")
                continue
            ds = json.loads(ps.read_text()) if ps.exists() else None
            dm = json.loads(pm.read_text())
            c1 = ds["roofline"]["collective_s"] if ds else float("nan")
            c2 = dm["roofline"]["collective_s"]
            lines.append(
                f"| {arch} | {shape} | ✓ ({dm['pass_seconds']}s) | "
                f"{c1:.2e} → {c2:.2e} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    print(roofline_table(args.dryrun_dir))
    print()
    print(multipod_summary(args.dryrun_dir))


if __name__ == "__main__":
    main()
