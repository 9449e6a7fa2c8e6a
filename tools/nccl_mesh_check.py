#!/usr/bin/env python3
"""Run the sharded executors with one rank on each GPU of the host, over
NCCL and then over gloo, against the dense executor on one GPU.

``chip_smoke.py`` phase 5d puts 8 ranks on one card, which only gloo can
do: NCCL refuses two ranks on one device, which ``--same-device`` shows
(two ranks on ``cuda:0``, one NCCL ``all_reduce`` under a 40 s group
timeout; one ``NCCL_PAIR {...}`` line with the exit codes and the last
lines of each rank's error).  On a host with two GPUs or more this check gives every rank a GPU of its
own: ``fit_sharded`` on ring(world), ``fit_sharded_graph`` on star(world)
and a zero-delay tape on star(world) against the no-tape run, each rank
reducing its own rows (one ``gram_tri`` launch), at L 1024, r 1, 12
iterations; per transport it prints one ``MESH_CHECK {...}`` line with the
gaps to ``fit_dense`` (objective within OBJECTIVE_TOL; U·A printed), the
identity, the launches and the seconds per iteration.

    python3 tools/nccl_mesh_check.py                       # every GPU
    python3 tools/nccl_mesh_check.py --backend gloo --device cpu --world 4
    python3 tools/nccl_mesh_check.py --same-device         # one GPU
"""

import argparse
import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

OBJECTIVE_TOL = 1e-5
SHAPE = {"N": 4096, "L": 1024, "d": 3, "iters": 12}


def inputs(world: int, device: str):
    """H (world, N, L) and T from seed 0, the same bits on every rank."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    H = torch.rand(world, SHAPE["N"], SHAPE["L"], device=device,
                   generator=gen)
    T = torch.randn(world, SHAPE["N"], SHAPE["d"], device=device,
                    generator=gen)
    return H, T


def config():
    from repro_torch.core import engine

    return engine.ConsensusConfig(r=1, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0,
                                  iters=SHAPE["iters"])


def rank_main(rank: int, world: int, device: str) -> dict:
    import torch

    from repro_torch import netsim
    from repro_torch.core import engine, graph, sharded_dmtl
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels.gram import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    H, T = inputs(world, str(dev))
    H, T = H[rank:rank + 1].clone(), T[rank:rank + 1].clone()
    mesh = make_mesh((world,), ("a",), device=dev)
    cfg = config()
    star = graph.star(world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def cpu(U, A, diags):
        return {"U": U.cpu(), "A": A.cpu(),
                "diags": {k: v.cpu() for k, v in diags.items()}}

    kernel.reset_launches()
    st = engine.produce_stats(H, T)
    out = {"rank": rank, "device": str(dev), "transport": mesh.transport,
           "launches": dict(kernel.LAUNCHES)}
    secs = {}
    for name, fn in (
            ("ring", lambda: sharded_dmtl.dmtl_fit_from_stats(
                st.G, st.R, mesh, ("a",), cfg, n=st.n, t2=st.t2)),
            ("star", lambda: sharded_dmtl.dmtl_fit_from_stats(
                st.G, st.R, mesh, ("a",), cfg, n=st.n, t2=st.t2, g=star)),
            ("star_zero_delay", lambda: sharded_dmtl.dmtl_fit_from_stats(
                st.G, st.R, mesh, ("a",), cfg, n=st.n, t2=st.t2, g=star,
                tape=netsim.zero_delay_tape(cfg.iters, star)))):
        times = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            times.append(time.perf_counter() - t0)
        out[name] = cpu(*res)
        secs[name] = min(times) / cfg.iters
    out["s_per_iter"] = secs
    return out


def pair_rank(rank: int, path: str, out: str) -> None:
    """One of the two NCCL ranks of ``--same-device``, both on cuda:0; it
    writes its result or its traceback to ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"file://{path}", rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=40))
        x = torch.full((4,), float(rank), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        with open(f"{out}.{rank}", "w") as f:
            f.write(f"all_reduce {x.tolist()}")
        dist.destroy_process_group()
    except Exception:
        with open(f"{out}.{rank}", "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def same_device() -> int:
    """Two NCCL ranks on one GPU (``mesh.spawn`` refuses this, so the ranks
    are started here); prints what NCCL said."""
    import torch

    tmp = tempfile.mkdtemp(prefix="nccl_pair_")
    path, out = os.path.join(tmp, "rendezvous"), os.path.join(tmp, "rank")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=pair_rank, args=(r, path, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(90)
        if p.exitcode is None:
            p.kill()
            p.join()
    said = {}
    for r in range(2):
        try:
            with open(f"{out}.{r}") as f:
                text = f.read()
        except FileNotFoundError:
            text = ""
        said[r] = [line for line in text.splitlines()
                   if "NCCL" in line or "Duplicate" in line
                   or "all_reduce" in line or "Error" in line][-4:]
    print("NCCL_PAIR " + json.dumps({
        "torch": torch.__version__, "nccl": ".".join(
            str(v) for v in torch.cuda.nccl.version()),
        "device": torch.cuda.get_device_name(0),
        "exit_codes": [p.exitcode for p in procs], "said": said}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", choices=("nccl", "gloo", "both"),
                        default="both")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--world", type=int, default=0,
                        help="ranks (default: one a GPU)")
    parser.add_argument("--same-device", action="store_true",
                        help="only try two NCCL ranks on cuda:0")
    args = parser.parse_args()
    import torch

    from repro_torch.core import engine, graph
    from repro_torch.core.mesh import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        print("nccl_mesh_check: needs a CUDA device", file=sys.stderr)
        return 2
    if args.same_device:
        return same_device()
    world = args.world or torch.cuda.device_count()
    if world < 2:
        print(f"nccl_mesh_check: needs 2 ranks or more, got {world}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    H, T = inputs(world, args.device)
    stats = engine.produce_stats(H, T)
    del H, T
    cfg = config()
    dense = {}
    for name, g in (("ring", graph.ring(world)), ("star", graph.star(world))):
        st, diags = engine.fit_dense(stats, g, cfg)
        dense[name] = (st.U.cpu(), st.A.cpu(), diags["objective"].cpu())
    backends = ("nccl", "gloo") if args.backend == "both" else (args.backend,)
    ok = True
    for backend in backends:
        t0 = time.perf_counter()
        ranks = spawn(rank_main, world, backend=backend, device=args.device,
                      timeout_s=300, args=(world, args.device))
        seconds = time.perf_counter() - t0
        res = ranks[0]
        gaps = {}
        for name in ("ring", "star"):
            U, A, obj = dense[name]
            got = res[name]
            x, y = got["diags"]["objective"].double(), obj.double()
            ua, ua_d = got["U"] @ got["A"], U @ A
            gaps[name] = {
                "objective": float(((x - y).abs() / y.abs()).max()),
                "UA": float(((ua - ua_d).flatten(1).norm(dim=1)
                             / ua_d.flatten(1).norm(dim=1)).max())}
        zero = res["star_zero_delay"]
        identity = (torch.equal(zero["U"], res["star"]["U"])
                    and torch.equal(zero["A"], res["star"]["A"])
                    and all(torch.equal(zero["diags"][k], v)
                            for k, v in res["star"]["diags"].items()))
        same_ranks = all(torch.equal(r["ring"]["U"], res["ring"]["U"])
                         for r in ranks)
        launches = [r["launches"]["gram_tri"] for r in ranks]
        passed = (identity and same_ranks
                  and all(g["objective"] <= OBJECTIVE_TOL
                          for g in gaps.values())
                  and (args.device == "cpu" or launches == [1] * world))
        ok = ok and passed
        print("MESH_CHECK " + json.dumps({
            "backend": backend, "transport": res["transport"],
            "world": world, "devices": [r["device"] for r in ranks],
            "gram_tri_launches": launches,
            "rel_diff_vs_dense": gaps,
            "zero_delay_tape_bitwise": identity,
            "ranks_agree": same_ranks,
            "s_per_iter": res["s_per_iter"],
            "world_s": seconds, "passed": passed,
            "shape": SHAPE, "r": cfg.r}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
