"""Run reports: a markdown + JSON summary of one consensus run.

``render(diags, spans)`` folds the diagnostics trajectory (including the
``cfg.telemetry`` comm/aggregator counters when present), the tracer's
span list, and the health verdict into one human-readable markdown
document and a machine-readable dict; ``write`` persists both next to
the trace artifacts.  The layout is the reference's (``repro.obs.report``).
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.obs.health import HealthConfig, check_health, host

_COUNTER_KEYS = ("msgs_delivered", "msgs_stale", "msgs_dropped",
                 "agg_rejected", "comm_floats")


def _span_breakdown(spans) -> list[dict]:
    """Total wall time per span name, top-level spans only (depth 0), so
    nested segment/snapshot time is not double counted."""
    totals: dict[str, dict] = {}
    for s in spans or []:
        if s.get("depth", 0) != 0:
            continue
        row = totals.setdefault(s["name"], {"name": s["name"],
                                            "count": 0, "total_us": 0.0})
        row["count"] += 1
        row["total_us"] += float(s["dur"])
    return sorted(totals.values(), key=lambda r: -r["total_us"])


def render(
    diags: dict,
    spans=None,
    meta: dict | None = None,
    health_cfg: HealthConfig | None = None,
) -> tuple[str, dict]:
    """Returns ``(markdown, data)`` summarizing one run."""
    obj = host(diags["objective"])
    cons = host(diags.get("consensus", []))
    verdict = check_health(diags, health_cfg)
    data: dict = {
        "iterations": int(obj.size),
        "objective_first": float(obj[0]) if obj.size else None,
        "objective_final": float(obj[-1]) if obj.size else None,
        "consensus_final": float(cons[-1]) if cons.size else None,
        "health": verdict,
        "meta": dict(meta or {}),
        "time_breakdown": _span_breakdown(spans),
    }
    comm = {}
    for key in _COUNTER_KEYS:
        if key in diags:
            comm[key + "_total"] = float(host(diags[key]).sum())
    if "resid_max" in diags:
        comm["resid_max_final"] = float(host(diags["resid_max"])[-1])
    data["comm"] = comm

    lines = ["# Run report", ""]
    if meta:
        lines += ["## Run", ""]
        lines += [f"- **{k}**: {v}" for k, v in sorted(meta.items())]
        lines += [""]
    lines += ["## Outcome", ""]
    status = "healthy" if verdict["healthy"] else (
        f"DNF (`{verdict['dnf_reason']}` at iteration {verdict['at_iter']})")
    lines += [
        f"- **iterations**: {data['iterations']}",
        f"- **objective**: {data['objective_first']} → "
        f"{data['objective_final']}",
        f"- **final consensus**: {data['consensus_final']}",
        f"- **health**: {status}",
        "",
    ]
    if comm:
        lines += ["## Communication", ""]
        lines += [f"- **{k}**: {v}" for k, v in sorted(comm.items())]
        lines += [""]
    if data["time_breakdown"]:
        lines += ["## Time breakdown (top-level spans)", "",
                  "| span | count | total ms |",
                  "| --- | ---: | ---: |"]
        lines += [
            f"| {r['name']} | {r['count']} | {r['total_us'] / 1e3:.3f} |"
            for r in data["time_breakdown"]
        ]
        lines += [""]
    return "\n".join(lines), data


def write(
    trace_dir,
    diags: dict,
    spans=None,
    meta: dict | None = None,
    health_cfg: HealthConfig | None = None,
) -> dict:
    """Render and persist report.md + report.json under ``trace_dir``."""
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    md, data = render(diags, spans, meta, health_cfg)
    md_path = trace_dir / "report.md"
    json_path = trace_dir / "report.json"
    md_path.write_text(md)
    with json_path.open("w") as f:
        json.dump(data, f, indent=2)
    return {"markdown": md_path, "json": json_path, "data": data}
