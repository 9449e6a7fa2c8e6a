"""World functions of the sharded-executor tests: each runs on every rank of
a gloo world started by ``repro_torch.core.mesh.spawn``.

A spawned rank imports its function by module name, so they live here, in
a module of ``tests/`` (on ``sys.path`` under pytest, and passed on to the
spawned children) that imports neither JAX nor pytest.  Every world runs
many cases, because a world costs seconds to start.  Inputs arrive as a dict
of numpy arrays and configs; each world returns a dict of CPU tensors and
plain values (``torch.save``-able), the same on every rank where the
executors gather their results.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import checkpoint, netsim, obs
from repro_torch.core import dmtl_elm, engine, graph, heads, sharded_dmtl
from repro_torch.core.mesh import make_mesh


def stats_of(inp: dict, prefix: str = "") -> engine.SufficientStats:
    return engine.SufficientStats(
        G=torch.as_tensor(inp[prefix + "G"]),
        R=torch.as_tensor(inp[prefix + "R"]),
        n=torch.as_tensor(inp[prefix + "n"]),
        t2=torch.as_tensor(inp[prefix + "t2"]))


def _fit(fn, *args, **kw):
    U, A, diags = fn(*args, **kw)
    return {"U": U, "A": A, "diags": diags}


def _error(fn) -> str | None:
    """The type and message of what ``fn()`` raises, or None."""
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def interrupted(runner, ckpt: Path, at: int, executor: str) -> None:
    """Run ``runner``'s first ``at`` iterations and snapshot them as
    ``run_checkpointed`` does (rank 0 writes, every rank waits)."""
    state, diags = runner.run_segment(runner.init_state(), at)
    if runner.mesh.rank == 0:
        checkpoint.save_run_checkpoint(
            ckpt, state, diags,
            metadata={"executor": executor, "iters": runner.cfg.iters})
    runner.mesh.barrier()


def port8(rank: int, inp: dict) -> dict:
    """Eight ranks: the torus paths, the compiled graph, the robust
    aggregators, telemetry, the tape and resume identities, the entry
    points and their validation errors."""
    mesh = make_mesh((8,), ("a",), device="cpu")
    mesh24 = make_mesh((2, 4), ("pod", "data"), device="cpu")
    st = stats_of(inp)
    cfg = inp["cfg"]
    tcfg = dataclasses.replace(cfg, telemetry=True)
    ring, star, cube = graph.ring(8), graph.star(8), graph.hypercube(3)
    out = {"rank": rank, "transport": mesh.transport}
    out["torus8"] = _fit(engine.fit_sharded, st, mesh, ("a",), cfg)
    out["torus24"] = _fit(engine.fit_sharded, st, mesh24, ("pod", "data"),
                          cfg)
    out["star8"] = _fit(engine.fit_sharded_graph, st, mesh, ("a",), star,
                        cfg)
    for name, g, agg in (("ring_trimmed_mean", None, "trimmed_mean"),
                         ("star_coordinate_median", star,
                          "coordinate_median"),
                         ("cube_krum_like", cube, "krum_like")):
        c = dataclasses.replace(tcfg, aggregator=agg)
        out[name] = (_fit(engine.fit_sharded, st, mesh, ("a",), c)
                     if g is None else
                     _fit(engine.fit_sharded_graph, st, mesh, ("a",), g, c))
    out["ring_telemetry"] = _fit(engine.fit_sharded, st, mesh, ("a",), tcfg)
    out["star_telemetry"] = _fit(engine.fit_sharded_graph, st, mesh, ("a",),
                                 star, tcfg)

    # tape identities on hypercube(3), bit for bit
    iters = cfg.iters
    out["cube"] = _fit(engine.fit_sharded_graph, st, mesh, ("a",), cube,
                       tcfg)
    zero = netsim.zero_delay_tape(iters, cube)
    for aged in (False, True):
        out[f"cube_zero_delay_aged{int(aged)}"] = _fit(
            engine.fit_sharded_graph, st, mesh, ("a",), cube, tcfg,
            tape=zero, aged_duals=aged)
    base = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.2,
                               straggler_prob=0.2, seed=3).sample(cube, iters)
    L, r = st.G.shape[-1], cfg.r
    zero_adv = netsim.zero_adversary_tape(base, L, r)
    for name, tape in (("base", base), ("zero_attack", zero_adv)):
        out[f"cube_{name}_tape"] = _fit(
            engine.fit_sharded_graph, st, mesh, ("a",), cube, tcfg,
            tape=tape, aged_duals=True)
    attack = netsim.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                                   churn=((2, 3, 6),), seed=0).sample(
        cube, iters, L=L, r=r)
    out["cube_attack_median"] = _fit(
        engine.fit_sharded_graph, st, mesh, ("a",), cube,
        dataclasses.replace(tcfg, aggregator="coordinate_median"),
        tape=attack)

    # resume: stopped after 4 iterations, resumed == uninterrupted
    ckdir = Path(inp["tmp"])
    for name, g, kw in (("torus", None, {}),
                        ("cube_channel", cube,
                         dict(tape=base, aged_duals=True))):
        want = _fit(sharded_dmtl.dmtl_fit_from_stats, st.G, st.R, mesh,
                    ("a",), cfg, n=st.n, t2=st.t2, g=g, **kw)
        ckpt = ckdir / name
        executor = "sharded" if g is None else "sharded_graph"
        interrupted(engine.make_runner(st, g, cfg, executor=executor,
                                       mesh=mesh, agent_axes=("a",), **kw),
                    ckpt, 4, executor)
        got = _fit(sharded_dmtl.dmtl_fit_from_stats, st.G, st.R, mesh,
                   ("a",), cfg, n=st.n, t2=st.t2, g=g, checkpoint_dir=ckpt,
                   checkpoint_every=4, resume=True, **kw)
        out[f"resume_{name}"] = {"want": want, "got": got}
    out["checkpoint_meta"] = checkpoint.read_meta(ckdir / "cube_channel")
    # the health monitor stops every rank at the same segment; rank 0
    # writes the trace and the report
    out["health_stop"] = _fit(
        sharded_dmtl.dmtl_fit_from_stats, st.G, st.R, mesh, ("a",), cfg,
        n=st.n, t2=st.t2, checkpoint_dir=ckdir / "health",
        checkpoint_every=2, health=obs.HealthConfig(
            stall_window=2, stall_tol=10.0, consensus_floor=0.0))
    out["health_meta"] = checkpoint.read_meta(ckdir / "health")
    out["traced"] = _fit(sharded_dmtl.dmtl_fit_from_stats, st.G, st.R, mesh,
                         ("a",), cfg, n=st.n, t2=st.t2, g=cube,
                         telemetry=True, trace_dir=ckdir / "trace")

    # the entry points: fit from raw data (this rank's own block), a ring
    # written with one flipped edge (the torus path), the heads
    H, T = torch.as_tensor(inp["H"]), torch.as_tensor(inp["T"])
    flipped = graph.Graph(m=8, edges=((1, 0),) + ring.edges[1:])
    out["fit_flipped_ring"] = _fit(
        dmtl_elm.fit, H[rank:rank + 1], T[rank:rank + 1], flipped, cfg,
        executor="sharded", mesh=mesh, agent_axes=("a",), telemetry=True)
    out["fit_gauss_seidel_cube"] = _fit(
        dmtl_elm.fit, H, T, cube, cfg, executor="sharded", mesh=mesh,
        agent_axes=("a",), schedule=cube.chromatic_schedule())
    out["fit_raw_star"] = _fit(sharded_dmtl.dmtl_elm_fit_sharded, H, T, mesh,
                               ("a",), cfg, g=star)
    head, diags = heads.fit_head(st, mesh, ("a",), cfg)
    out["fit_head"] = {"U": head.U, "A": head.A, "diags": diags}

    # validation
    runner = engine.make_runner(st, None, cfg, executor="sharded",
                                mesh=mesh, agent_axes=("a",))
    state = runner.run_segment(runner.init_state(), 1)[0]
    out["errors"] = {
        "graph_size": _error(lambda: dmtl_elm.fit(
            H, T, graph.ring(4), cfg, executor="sharded", mesh=mesh,
            agent_axes=("a",))),
        "stats_rows": _error(lambda: engine.fit_sharded(
            engine.SufficientStats(st.G[:4], st.R[:4]), mesh, ("a",), cfg)),
        "non_agent_axis": _error(lambda: engine.fit_sharded(
            st, mesh24, ("data",), cfg)),
        "axis_order": _error(lambda: engine.fit_sharded(
            st, mesh24, ("data", "pod"), cfg)),
        "graph_runner_without_g": _error(lambda: engine.make_runner(
            st, None, cfg, executor="sharded_graph", mesh=mesh,
            agent_axes=("a",))),
        "tape_with_schedule": _error(lambda: engine.fit_sharded_graph(
            st, mesh, ("a",), cube, cfg, schedule=cube.chromatic_schedule(),
            tape=zero)),
        "tape_without_g": _error(lambda: sharded_dmtl.dmtl_fit_from_stats(
            st.G, st.R, mesh, ("a",), cfg, tape=zero)),
        "aged_duals_without_tape": _error(lambda: dmtl_elm.fit(
            H, T, cube, cfg, executor="sharded", mesh=mesh,
            agent_axes=("a",), aged_duals=True)),
        "remap_sharded_layout": _error(lambda: checkpoint.remap_membership(
            state, ring, graph.ring(9))),
    }
    return out


def ref8(rank: int, inp: dict) -> dict:
    """Eight ranks: the cases ``tests/test_torch_sharded_ref.py``'s
    reference subprocess runs, on its statistics, and the resumes of its
    two mid-run checkpoints."""
    mesh = make_mesh((8,), ("a",), device="cpu")
    mesh24 = make_mesh((2, 4), ("pod", "data"), device="cpu")
    st = stats_of(inp)
    cfg = inp["cfg"]
    L, r = st.G.shape[-1], cfg.r
    cube, star = graph.hypercube(3), graph.star(8)
    channel = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.2,
                                  straggler_prob=0.2, seed=3).sample(
        cube, cfg.iters)
    attack = netsim.AdversaryModel(
        n_byzantine=1, kinds=("sign_flip",), churn=((2, 3, 6),),
        seed=0).sample(cube, cfg.iters, L=L, r=r)
    median = dataclasses.replace(cfg, aggregator="coordinate_median")

    def fs(*a, **kw):
        return _fit(sharded_dmtl.dmtl_fit_from_stats, st.G, st.R, *a,
                    n=st.n, t2=st.t2, **kw)

    H, T = torch.as_tensor(inp["H"]), torch.as_tensor(inp["T"])
    ckpt = Path(inp["ckpt"])
    return {
        "torus8": fs(mesh, ("a",), cfg),
        "torus24": fs(mesh24, ("pod", "data"), cfg),
        "star8": fs(mesh, ("a",), cfg, g=star),
        "gs_cube": _fit(engine.fit_sharded_graph, st, mesh, ("a",), cube,
                        cfg, schedule=cube.chromatic_schedule()),
        "channel_aged_cube": fs(mesh, ("a",), cfg, g=cube, tape=channel,
                                aged_duals=True),
        "attack_median_cube": fs(mesh, ("a",), median, g=cube, tape=attack),
        "fit_ring_telemetry": _fit(
            dmtl_elm.fit, H, T, graph.ring(8), cfg, executor="sharded",
            mesh=mesh, agent_axes=("a",), telemetry=True),
        "resumed_torus": fs(mesh, ("a",), cfg, checkpoint_dir=ckpt / "torus",
                            checkpoint_every=4, resume=True),
        "resumed_cube": fs(mesh, ("a",), cfg, g=cube, tape=channel,
                           aged_duals=True, checkpoint_dir=ckpt / "cube",
                           checkpoint_every=4, resume=True),
    }


def port5(rank: int, inp: dict) -> dict:
    """Five ranks on fig2a: the Jacobian sweep and Gauss-Seidel phases."""
    mesh = make_mesh((5,), ("a",), device="cpu")
    st = stats_of(inp)
    g, cfg = graph.paper_fig2a(), inp["cfg"]
    sched = inp["schedule"]
    return {
        "jacobian": _fit(engine.fit_sharded_graph, st, mesh, ("a",), g, cfg),
        "gauss_seidel": _fit(engine.fit_sharded_graph, st, mesh, ("a",), g,
                             cfg, schedule=sched),
        "gauss_seidel_telemetry": _fit(
            engine.fit_sharded_graph, st, mesh, ("a",), g,
            dataclasses.replace(cfg, telemetry=True), schedule=sched),
    }


def port2(rank: int, inp: dict) -> dict:
    """Two ranks: ring(2), the degenerate single-edge ring, on the torus
    path, and chain(2) on the compiled path."""
    mesh = make_mesh((2,), ("a",), device="cpu")
    st = stats_of(inp)
    cfg = dataclasses.replace(inp["cfg"], telemetry=True)
    return {
        "ring2": _fit(engine.fit_sharded, st, mesh, ("a",), cfg),
        "chain2": _fit(engine.fit_sharded_graph, st, mesh, ("a",),
                       graph.chain(2), cfg),
    }


def fit_head_world(rank: int, stats: dict, cfg) -> tuple:
    """``heads.fit_head`` on the ring of as many ranks as the stats hold
    agents: this rank's (U, A, diagnostics)."""
    st = stats_of(stats)
    mesh = make_mesh((st.G.shape[0],), ("agents",), device="cpu")
    head, diags = heads.fit_head(st, mesh, ("agents",), cfg)
    return head.U, head.A, diags


def cuda_pair(rank: int, inp: dict) -> dict:
    """Two ranks on the card (gloo, messages through host buffers): the raw
    data entry on each rank's own rows, one ``gram_tri`` launch a rank,
    then ring(2) on the torus path and the compiled chain(2)."""
    from repro_torch.kernels.gram import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("a",), device="cuda")
    H = torch.as_tensor(inp["H"][rank:rank + 1], device="cuda")
    T = torch.as_tensor(inp["T"][rank:rank + 1], device="cuda")
    cfg = inp["cfg"]
    kernel.reset_launches()
    raw = _fit(sharded_dmtl.dmtl_elm_fit_sharded, H, T, mesh, ("a",), cfg)
    launches = dict(kernel.LAUNCHES)
    chain = _fit(sharded_dmtl.dmtl_elm_fit_sharded, H, T, mesh, ("a",), cfg,
                 g=graph.Graph(m=2, edges=((1, 0),)))
    compiled = _fit(engine.fit_sharded_graph, engine.produce_stats(H, T),
                    mesh, ("a",), graph.chain(2), cfg)
    cpu = {name: {"U": r["U"].cpu(), "A": r["A"].cpu(),
                  "objective": r["diags"]["objective"].cpu()}
           for name, r in (("ring2", raw), ("flipped", chain),
                           ("chain2", compiled))}
    return {"transport": mesh.transport, "launches": launches,
            "device": str(raw["U"].device), **cpu}


def failing(rank: int, bad_rank: int) -> None:
    """One rank raises while the others wait for its message."""
    mesh = make_mesh((4,), ("a",), device="cpu")
    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    mesh.ppermute(torch.ones(3), mesh.axis_shift(0, 1))
    mesh.barrier()


def moe_shardmap_world(rank: int, inp: dict) -> dict:
    """``moe.moe_ffn`` with ``moe_impl="shardmap"`` under ``use_mesh`` on a
    (data, model) mesh of ``inp["mesh"]``: this rank's output block, aux,
    and its gradients of sum(out**2) + aux / world (summed over the world,
    they are the whole batch's); and the shape ``moe_impl="gspmd"`` gives
    under the same mesh."""
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh

    mesh = make_mesh(inp["mesh"], ("data", "model"), device="cpu")
    params = {k: {"w": torch.tensor(v).requires_grad_()}
              for k, v in inp["params"].items()}
    x = torch.tensor(inp["x"])
    cfg = inp["cfg"]
    with use_mesh(mesh):
        out, aux = moe.moe_ffn(params, cfg, x)
        loss = out.square().sum() + aux / mesh.size
        grads = torch.autograd.grad(loss, [p["w"] for p in params.values()])
        gspmd = moe.moe_ffn(params, dataclasses.replace(
            cfg, moe_impl="gspmd"), x)[0]
    return {"coords": mesh.coords(rank), "out": out.detach(),
            "aux": aux.detach(), "grads": dict(zip(params, grads)),
            "gspmd_shape": tuple(gspmd.shape)}


def dmtl_model_axis_world(rank: int, inp: dict) -> dict:
    """``dmtl_elm.fit(executor="sharded")`` with the agents on ``"data"`` of
    a mesh of ``inp["mesh"]`` over ``inp["names"]`` (a ``model`` axis, when
    present, holds no agents): ring(4) (the torus path) and star(4) (the
    compiled graph path)."""
    mesh = make_mesh(inp["mesh"], inp["names"], device="cpu")
    H, T = torch.as_tensor(inp["H"]), torch.as_tensor(inp["T"])
    out = {"coords": mesh.coords(rank)}
    for name, g in (("ring", graph.ring(4)), ("star", graph.star(4))):
        out[name] = _fit(dmtl_elm.fit, H, T, g, inp["cfg"],
                         executor="sharded", mesh=mesh, agent_axes=("data",))
    return out


def data_parallel_world(rank: int, inp: dict) -> dict:
    """A data-parallel training step on a (world,) ``"data"`` mesh: this
    rank's rows of ``inp["batch"]`` through ``loss_and_grads`` and
    ``train_step`` under ``use_mesh`` (every rank from a copy of the
    weights ``inp["params"]``), and ``loss_and_grads`` in 2 microbatches.  Returns the
    losses, metrics, gradients, the updated parameters and this rank's
    torch thread count."""
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
    from repro_torch.training import steps

    world = inp["world"]
    mesh = make_mesh((world,), ("data",), device="cpu")
    cfg = inp["cfg"]
    b = len(inp["batch"]["tokens"]) // world
    batch = {k: torch.as_tensor(v[rank * b:(rank + 1) * b])
             for k, v in inp["batch"].items()}

    def params():
        return tree_map(torch.clone, inp["params"])

    with use_mesh(mesh):
        loss, metrics, grads = steps.loss_and_grads(params(), cfg, batch)
        loss2, _, grads2 = steps.loss_and_grads(params(), cfg, batch, 2)
        p = params()
        new, _, step_metrics = steps.train_step(p, adamw_init(p), batch, cfg,
                                                AdamWConfig())
    return {"loss": loss, "metrics": metrics, "grads": grads, "params": new,
            "step_loss": step_metrics["loss"], "loss_mb2": loss2,
            "grads_mb2": grads2,
            "threads": torch.get_num_threads()}
