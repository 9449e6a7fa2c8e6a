"""Perf-hillclimb harness (the reference's ``analysis/hillclimb.py``): one
(arch, shape) through the dry run's plan and shape pass with knob
overrides, reporting the roofline terms and peak memory, for fast
hypothesis -> change -> re-run -> measure iterations.  No card: it runs in
a fake world of the production mesh (``launch.dryrun``).

Knobs:
  --microbatches N       gradient accumulation (train shapes)
  --serve-bf16           serving-path fp32 parameters held as bf16, in the
                         plan's bytes and in the pass
  --cfg key=value ...    arbitrary ModelConfig overrides (ints/floats/bools)

The reference's ``--unrolled``, ``--save-hlo`` and ``--no-seq-shard`` have
no counterpart: the port's layers are never stacked in a scan, there is no
HLO, and a rank holds whole activations whichever layout
``models/sharding.py`` names (its helpers return x unchanged), so keeping S
whole would move no number of the pass.

Example:
  PYTHONPATH=src python -m repro_torch.analysis.hillclimb \\
      --arch llava-next-34b --shape train_4k --microbatches 2
"""

from __future__ import annotations

import argparse
import json

from repro_torch.analysis.flops import analytic_cost
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_world, shape_pass
from repro_torch.launch.mesh import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from repro_torch.launch.shapes import SHAPES, variant_for_shape


def lower(arch, shape_name, *, multi_pod=False, microbatches=1,
          serve_bf16=False, cfg_overrides=None) -> dict:
    """The dry run's pass of one combo with the knobs, in the fake world of
    256 (512) ranks the caller made (``launch.dryrun.fake_world``)."""
    shape = SHAPES[shape_name]
    cfg = variant_for_shape(get_config(arch, **(cfg_overrides or {})), shape)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rec = shape_pass(cfg, shape, mesh, microbatches=microbatches,
                     serve_bf16=serve_bf16)
    coll = rec["collectives"]
    ana = analytic_cost(cfg, shape)
    return {
        "compile_s": round(rec["pass_seconds"], 1),
        "peak_gb": (rec["argument_bytes"] + rec["output_bytes"]) / 1e9,
        "temp_gb": None,
        "arg_gb": rec["argument_bytes"] / 1e9,
        "compute_s": ana["flops"] / mesh.size / PEAK_FLOPS_BF16,
        "memory_s": rec["argument_bytes"] / HBM_BW,
        "collective_s": coll["total"] / LINK_BW,
        "coll_gb": {k: round(v / 1e9, 2) for k, v in coll.items()
                    if k != "counts" and v},
        "coll_counts": coll["counts"],
    }


def parse_overrides(kvs) -> dict:
    """``key=value`` strings -> overrides: int, else float, else the string,
    and "True"/"False" as bools (the reference's casts)."""
    overrides = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--cfg", nargs="*", default=[])
    args = ap.parse_args(argv)
    with fake_world(512 if args.multi else 256):
        result = lower(args.arch, args.shape, multi_pod=args.multi,
                       microbatches=args.microbatches,
                       serve_bf16=args.serve_bf16,
                       cfg_overrides=parse_overrides(args.cfg))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
