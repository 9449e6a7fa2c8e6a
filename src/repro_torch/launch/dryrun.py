"""Multi-pod dry run with no card (the reference's ``launch/dryrun.py``):
every (architecture x input shape) on the production meshes, in a world of
256 (or 512) ranks made in one process, and the roofline terms of each.

The reference lowers and compiles each combo with XLA on 512 forced host
devices and reads memory, FLOPs and collective bytes from the compiled
artifact.  The port has no compiler between its code and the card, so its
dry run is a **shape pass**: rank 0 of a ``"fake"`` process group of the
production world (``fake_world``; ``torch.testing``'s ``FakeStore``) runs
its step at its local shapes on meta tensors under ``use_mesh``, which
proves that the code runs at those shapes on that mesh and counts the
collectives it issues (``core.mesh.COLLECTIVES``).  The port holds whole
weights on each rank (``models/sharding.py``), so the parameter layout is a
**plan**: ``launch.shardings``' specs, filtered against the mesh and each
leaf's shape, give every tensor's local shape, and the bytes per device are
the plan's sums.  Nothing is allocated: every tensor is on the meta device.

Per combo:
  1. the config, ``variant_for_shape(get_config(arch), SHAPES[shape])``;
  2. parameters on the meta device, ``params`` and ``params_active``
     counted as the reference counts them;
  3. the plan: ``param_specs`` (``fsdp="data"`` for train, else None),
     ``opt_specs``, ``batch_specs``, ``cache_specs``;
  4. bytes per device: arguments (parameters, optimizer state, batch,
     caches) and outputs (train: parameters and optimizer state; prefill:
     the caches; decode: the logits' batch shard and the caches);
  5. the shape pass: train ``train_step``, prefill ``prefill``, decode
     ``decode_step``, at B over the batch axes' product, the kernels'
     plain versions (``use_kernel=False``: meta tensors have no kernel);
  6. ``analysis.flops.analytic_cost`` per device.
``dmtl_4k`` runs the paper's technique as the reference lowers it: ``encode``
at B 256 x S 4096, pooled features, each agent's G and R, and
``core.sharded_dmtl.dmtl_fit_from_stats`` (10 ADMM iterations, the
Sylvester U-solve) on the agent axes, whose ring ``ppermute`` runs on meta
tensors.

The JSON keeps the reference's keys where the port computes the same
quantity.  Where it differs:
  - ``cost_source`` is ``"analytic"``: there is no HLO, so no
    ``compute_s_hlo``, and ``useful_flops_ratio`` (which needs HLO FLOPs)
    is null;
  - ``pass_seconds`` (the shape pass) stands where ``compile_seconds`` was;
  - ``temp_bytes_per_device`` is null: no allocator runs on meta;
  - ``peak_estimate_bytes`` is arguments plus outputs, and ``peak_ok_80gb``
    compares it with ``launch.mesh.HBM_BYTES`` (the reference's
    ``peak_ok_16gb`` is a v5e figure);
  - ``memory_s`` is the argument bytes over ``HBM_BW``: every argument
    byte read once, a floor (the reference reads XLA's bytes accessed);
  - ``collective_s`` is the bytes of the collectives the port issues over
    ``LINK_BW``: the data-parallel gradient all-reduce, MoE and ring
    messages.  XLA's GSPMD also inserts the gathers of sharded parameters,
    which the port, holding whole weights, does not issue.
``--save-hlo`` and ``--skip-unrolled`` have no counterpart and are gone:
there is no HLO, and the port's layers are never stacked in a scan, so
there is no unrolled variant to cost separately.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.flops import analytic_cost
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    LINK_BW,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from repro_torch.launch.shapes import SHAPES, input_specs, variant_for_shape
from repro_torch.models.cache import init_cache
from repro_torch.models.sharding import use_mesh
from repro_torch.models.transformer import (
    decode_step,
    encode,
    init_model,
    param_count,
    prefill,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    tree_leaves,
    tree_map,
)
from repro_torch.training.steps import train_step

DEFAULT_OUT = "experiments/dryrun_torch"
DMTL_B, DMTL_S, DMTL_R, DMTL_D_OUT = 256, 4096, 16, 16


@contextlib.contextmanager
def fake_world(world: int):
    """A ``"fake"`` process group of ``world`` ranks in this process, as
    rank 0 (collectives move nothing), destroyed on exit.  The group is
    process-global: nothing else may hold one meanwhile."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _OnMeta(TorchFunctionMode):
    """Every call that names a ``device`` makes its tensor on the meta
    device instead, its generator dropped: the parameters' shapes and
    dtypes without storage or draws."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("device") is not None:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def meta_model(cfg):
    """``init_model``'s tree for ``cfg`` on the meta device."""
    with _OnMeta():
        params = init_model(torch.Generator(), cfg)
    bad = [t.device for t in tree_leaves(params) if t.device.type != "meta"]
    if bad:
        raise RuntimeError(f"init_model made tensors on {set(bad)}")
    return params


def active_params(cfg, n_params: int) -> int:
    """The reference's count: every MoE layer's experts replaced by the
    active ones."""
    moe_layers = sum(1 for k in cfg.layer_kinds() if k == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    return (n_params - moe_layers * cfg.n_experts * per_expert
            + moe_layers * cfg.n_experts_active * per_expert)


def model_flops_per_step(cfg, shape, n_params, n_active):
    """6 N D (dense) / 6 N_active D (MoE); decode: D = batch tokens."""
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch  # decode: one token per sequence


def _bytes(specs, tree, mesh) -> int:
    return sh.plan_bytes(sh.filter_specs(specs, mesh, tree), tree, mesh)


def _local_batch(batch_size: int, mesh) -> int:
    """B over the batch axes' product, as ``batch_specs`` and ``_filter``
    split it (a batch of 1, or one those axes do not divide, stays
    whole)."""
    tree = {"t": torch.empty((batch_size,), device="meta")}
    spec = sh.filter_specs(sh.batch_specs(tree), mesh, tree)["t"]
    return sh.local_shape((batch_size,), spec, mesh)[0]


def _frontend(batch) -> dict:
    return {k: v for k, v in batch.items()
            if k in ("prefix_embeds", "enc_embeds")}


def shape_pass(cfg, shape, mesh, *, microbatches: int = 1,
               serve_bf16: bool = False) -> dict:
    """The plan's bytes per device and the shape pass of one (cfg, shape)
    on ``mesh`` (module docstring, steps 2-5): {"params",
    "params_active", "argument_bytes", "output_bytes", "collectives",
    "pass_seconds"}.
    ``serve_bf16`` holds a serving step's fp32 parameters as bf16, in the
    plan and in the pass."""
    params = meta_model(cfg)
    n_params = param_count(params)
    if serve_bf16 and shape.kind != "train":
        params = _cast(params, torch.float32, torch.bfloat16)
    fsdp = "data" if shape.kind == "train" else None
    raw = sh.param_specs(params, fsdp=fsdp, mesh=mesh)
    batch = input_specs(cfg, shape)
    args = _bytes(raw, params, mesh)
    if shape.kind == "train":
        opt = adamw_init(params)
        opt_bytes = _bytes(sh.opt_specs(opt, raw), opt, mesh)
        args += opt_bytes + _bytes(sh.batch_specs(batch), batch, mesh)
        outs = _bytes(raw, params, mesh) + opt_bytes
    elif shape.kind == "prefill":
        cache = init_cache(cfg, shape.batch, shape.seq, torch.bfloat16,
                           device="meta")
        args += _bytes(sh.batch_specs(batch), batch, mesh)
        outs = _bytes(sh.cache_specs(cache, cfg), cache, mesh)
    else:
        tokens, cache = {"tokens": batch["tokens"]}, batch["cache"]
        cache_bytes = _bytes(sh.cache_specs(cache, cfg), cache, mesh)
        logits = {"logits": torch.empty((shape.batch, 1, cfg.vocab_size),
                                        device="meta")}
        args += _bytes(sh.batch_specs(tokens), tokens, mesh) + cache_bytes
        outs = _bytes(sh.batch_specs(logits), logits, mesh) + cache_bytes

    local = dataclasses.replace(shape,
                                batch=_local_batch(shape.batch, mesh))
    lb = input_specs(cfg, local)
    core_mesh.reset_collectives()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        if shape.kind == "train":
            train_step(params, adamw_init(params), lb, cfg, AdamWConfig(),
                       microbatches=microbatches)
        elif shape.kind == "prefill":
            prefill(params, cfg, lb["tokens"], shape.seq, use_kernel=False,
                    **_frontend(lb))
        else:
            decode_step(params, cfg, lb["tokens"], lb["cache"],
                        use_kernel=False)
    return {"params": n_params, "params_active": active_params(cfg, n_params),
            "argument_bytes": args, "output_bytes": outs,
            "collectives": _collectives(),
            "pass_seconds": time.perf_counter() - t0}


def _cast(tree, src, dst):
    return tree_map(lambda x: x.to(dst) if x.dtype == src else x, tree)


def _collectives() -> dict:
    rec = core_mesh.COLLECTIVES
    out = dict(rec["bytes"])
    out["total"] = sum(rec["bytes"].values())
    out["counts"] = dict(rec["counts"])
    return out


def _dmtl_pass(cfg, mesh, multi_pod: bool, admm_iters: int = 10) -> dict:
    """``dmtl_4k``: the frozen backbone's features of this rank's B / m rows,
    its agent's G and R, and ``admm_iters`` rounds of DMTL-ELM over the
    agent axes (the reference's ``_lower_dmtl``; agents = the data axes)."""
    from repro_torch.core.engine import ConsensusConfig
    from repro_torch.core.sharded_dmtl import dmtl_fit_from_stats

    agent_axes = ("pod", "data") if multi_pod else ("data",)
    m_agents = math.prod(mesh.shape[a] for a in agent_axes)
    B, S, r, d_out, d = DMTL_B, DMTL_S, DMTL_R, DMTL_D_OUT, cfg.d_model
    params = meta_model(cfg)
    n_params = param_count(params)

    def inputs(b):
        batch = {"tokens": torch.empty((b, S), dtype=torch.int32,
                                       device="meta"),
                 "targets": torch.empty((b, d_out), device="meta")}
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.empty((b, cfg.enc_seq, d),
                                              dtype=torch.bfloat16,
                                              device="meta")
        return batch

    batch = inputs(B)
    raw = sh.param_specs(params, fsdp=None, mesh=mesh)
    args = _bytes(raw, params, mesh) + _bytes(sh.batch_specs(batch), batch,
                                              mesh)
    # every rank gets the gathered U (m, L, r) and A (m, r, d_out), fp32
    outs = 4 * m_agents * (d * r + r * d_out)
    lb = inputs(B // m_agents)
    admm = ConsensusConfig(r=r, iters=admm_iters, tau=2.0, zeta=1.0,
                           first_order=False, u_solver="sylvester")
    core_mesh.reset_collectives()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        h = encode(params, cfg, lb["tokens"], use_kernel=False,
                   **_frontend(lb))
        feats = h.float().mean(dim=1)                       # (B / m, d)
        G = (feats.T @ feats)[None]                         # this agent's
        R = (feats.T @ lb["targets"])[None]
        dmtl_fit_from_stats(G, R, mesh, agent_axes, admm)
    return {"params": n_params, "params_active": n_params,
            "argument_bytes": args, "output_bytes": outs,
            "collectives": _collectives(),
            "pass_seconds": time.perf_counter() - t0}


@dataclasses.dataclass(frozen=True)
class _DMTLShape:
    name: str = "dmtl_4k"
    kind: str = "prefill"      # feature extraction = forward pass accounting
    seq: int = DMTL_S
    batch: int = DMTL_B


def lower_combo(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One combo's record (module docstring), run in a fake world of 256
    ranks (512 with ``multi_pod``) that the caller made (``fake_world``)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    if shape_name == "dmtl_4k":
        cfg, shape = get_config(arch), _DMTLShape()
        rec = _dmtl_pass(cfg, mesh, multi_pod)
    else:
        shape = SHAPES[shape_name]
        cfg = variant_for_shape(get_config(arch), shape)
        rec = shape_pass(cfg, shape, mesh)
    return assemble(arch, shape_name, multi_pod, cfg, shape, mesh, rec)


def assemble(arch, shape_name, multi_pod, cfg, shape, mesh, rec) -> dict:
    n_chips = mesh.size
    model_fl = model_flops_per_step(cfg, shape, rec["params"],
                                    rec["params_active"])
    ana = analytic_cost(cfg, shape)
    ana_flops_dev = ana["flops"] / n_chips
    coll = rec["collectives"]
    peak = rec["argument_bytes"] + rec["output_bytes"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(n_chips),
        "pass_seconds": round(rec["pass_seconds"], 1),
        "cost_source": "analytic",
        "params": int(rec["params"]),
        "params_active": int(rec["params_active"]),
        "memory": {
            "argument_bytes_per_device": int(rec["argument_bytes"]),
            "output_bytes_per_device": int(rec["output_bytes"]),
            "temp_bytes_per_device": None,
            "peak_estimate_bytes": int(peak),
            "peak_ok_80gb": bool(peak < HBM_BYTES),
        },
        "collectives": coll,
        "roofline": {
            "compute_s": ana_flops_dev / PEAK_FLOPS_BF16,
            "compute_s_analytic": ana_flops_dev / PEAK_FLOPS_BF16,
            "memory_s": rec["argument_bytes"] / HBM_BW,
            "collective_s": coll["total"] / LINK_BW,
            "model_flops_total": model_fl,
            "useful_flops_ratio": None,
            "analytic_flops_total": ana["flops"],
        },
    }
    r = result["roofline"]
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: r[k])
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES) + ["dmtl_4k"])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    combos = (
        [(a, s, m) for a in ARCH_NAMES for s in SHAPES
         for m in ("single", "multi")]
        if args.all else [(args.arch, args.shape, args.mesh)]
    )
    failures = 0
    for arch, shape, mesh_kind in combos:
        tag = f"{arch}__{shape}__{mesh_kind}"
        path = out_dir / f"{tag}.json"
        if path.exists() and args.all:
            print(f"[skip] {tag}")
            continue
        multi = mesh_kind == "multi"
        try:
            with fake_world(512 if multi else 256):
                result = lower_combo(arch, shape, multi)
            path.write_text(json.dumps(result, indent=2))
            r = result["roofline"]
            print(f"[ok] {tag}: pass={result['pass_seconds']}s "
                  f"peak={result['memory']['peak_estimate_bytes']/1e9:.2f}GB "
                  f"dom={r['dominant']} "
                  f"(c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
                  f"x={r['collective_s']:.3e})", flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            (out_dir / f"{tag}.error.txt").write_text(traceback.format_exc())
    if failures:
        raise SystemExit(f"{failures} combo(s) failed")


if __name__ == "__main__":
    main()
