"""One agent per process: the device mesh of the sharded executors.

The reference lays its agents over the devices of a ``jax.sharding.Mesh``
and runs one ``shard_map`` body per device, trading subspaces with
``jax.lax.ppermute``.  Here each agent is one process ("rank") of a
``torch.distributed`` process group, and every rank runs the same Python
program:

* :class:`Mesh` / :func:`make_mesh`: named axes over the ranks of a process
  group (the counterpart of ``jax.make_mesh``, ``axis_index`` and
  ``axis_size``).  Rank ``t`` is the row-major flattening of its mesh
  coordinates, which is also its agent index.
* :meth:`Mesh.ppermute`: ``jax.lax.ppermute`` on point-to-point messages
  (``dist.batch_isend_irecv``): each rank sends to its destination in the
  permutation and receives from its source; a rank with no source receives
  zeros.  Each call waits for its own messages before it returns, so the
  two permutes of a degenerate 2-ring, both with the same peer, cannot
  cross.
* :meth:`Mesh.all_gather`: the per-agent rows stacked in agent order on
  every rank (the gathered diagnostics and final state; float sums over
  agents are then taken in agent order, never by ``all_reduce``, whose
  reduction order the library picks).
* :func:`spawn`: start a world of ranks on this host, for the tests and the
  smoke script (``torchrun`` is the launcher of a real deployment).

Transport: the process group the caller made.  NCCL moves CUDA tensors
when every rank has its own GPU.  gloo moves CPU tensors, and CUDA tensors
through an explicit copy to a host buffer and back (ranks that share one
GPU must use gloo: NCCL refuses two ranks on one device).  Nothing switches
transport or device when one fails: a failure raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of a process group; ``device`` is where
    this rank's agent computes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    group: object
    rank: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def transport(self) -> str:
        """The wire: ``"nccl"``, ``"gloo"``, or ``"gloo via host"`` for CUDA
        tensors over gloo."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo via host"
        return self.backend

    def coords(self, rank: int) -> tuple[int, ...]:
        out = []
        for size in reversed(self.sizes):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def flat(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, size in zip(coords, self.sizes):
            rank = rank * size + c
        return rank

    def axis_shift(self, axis: int, shift: int) -> tuple[tuple[int, int], ...]:
        """The permutation moving every rank's message ``shift`` steps
        along mesh axis ``axis`` (the other coordinates fixed)."""
        perm = []
        for rank in range(self.size):
            c = list(self.coords(rank))
            c[axis] = (c[axis] + shift) % self.sizes[axis]
            perm.append((rank, self.flat(c)))
        return tuple(perm)

    def check_agent_axes(self, agent_axes: Sequence[str]) -> tuple[str, ...]:
        """The agent axes as a tuple: every mesh axis, in the mesh's order
        (rank = agent index).  A mesh axis that holds no agents would shard
        something else across it, the model-sharding layer of
        ``repro/launch/shardings.py``, which is not ported."""
        axes = tuple(agent_axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"agent axes {unknown} are not axes of the mesh "
                             f"{self.axis_names}")
        extra = [a for a in self.axis_names if a not in axes]
        if extra:
            raise NotImplementedError(
                f"mesh axes {extra} hold no agents: sharding a model over "
                f"them is the port of sharding.py (ROADMAP queue 1 item 6)")
        if axes != self.axis_names:
            raise ValueError(f"agent_axes {axes} must list the mesh's axes in "
                             f"the mesh's order {self.axis_names}")
        return axes

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.backend == "gloo" and x.is_cuda:
            return x.cpu()
        return x

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: ``perm`` lists (source, destination) rank
        pairs, each rank at most once on each side.  Returns what this rank
        received, zeros where it has no source."""
        dst = next((d for s, d in perm if s == self.rank), None)
        src = next((s for s, d in perm if d == self.rank), None)
        if src is None and dst is None:
            return torch.zeros_like(x)
        wire = self._wire(x)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, wire, self._peer(dst),
                                  self.group))
        buf = None
        if src is not None:
            buf = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(src),
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if buf is None:
            return torch.zeros_like(x)
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: (size, *x.shape)."""
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        return torch.stack(parts).to(x.device)

    def barrier(self) -> None:
        self.all_gather(torch.zeros((1,), device=self.device))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              group=None, device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the ranks of ``group`` (the default
    process group when None, as ``torchrun`` sets it up).  The group's size
    must be ``prod(shape)``.  ``device`` defaults to the current CUDA
    device; the CPU only when the caller asks (``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: launch with "
            "torchrun (then dist.init_process_group()) or mesh.spawn")
    sizes = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"mesh shape {sizes} and axis names {names} differ "
                         f"in length")
    world = dist.get_world_size(group)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh shape {sizes} holds {math.prod(sizes)} ranks, "
                         f"the process group {world}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(axis_names=names, sizes=sizes, group=group,
                rank=dist.get_rank(group), device=torch.device(device),
                backend=str(dist.get_backend(group)))
    mesh.barrier()      # every rank is in, and the transport works
    return mesh


def _child(fn, rank, world, backend, device, init_file, timeout_s, args,
           out_dir):
    """One rank of :func:`spawn`: join the group, run ``fn(rank, *args)``,
    save its result (or its traceback) under ``out_dir``."""
    out = Path(out_dir)
    try:
        # one thread a rank: a world puts a rank on every core
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"result_{rank}.pt")
    except Exception:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        sys.exit(1)


def spawn(fn: Callable, world: int, *, backend: str = "gloo",
          device: str = "cpu", timeout_s: float = 300.0,
          args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined in one
    process group, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function): the
    children are started with the ``spawn`` method, never forked, so a
    parent that has initialised CUDA can start them.  The group meets at a
    ``file://`` rendezvous in a temporary directory.  ``device="cuda"``
    sets rank t on GPU ``t mod device_count`` (every rank on the one card
    of a one-GPU host, over gloo).  ``timeout_s`` bounds the whole world:
    it is the group's timeout, and the parent kills every rank and raises
    ``TimeoutError`` when the world has not finished by then; a rank that
    raises ends the world at once with ``RuntimeError`` and its traceback.
    Results are saved with ``torch.save``, so return CPU tensors, numpy
    arrays and plain Python values."""
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend moves CUDA tensors: "
                             "device='cuda'")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl puts one rank on each GPU: {world} ranks, "
                f"{torch.cuda.device_count()} GPUs (ranks that share a GPU "
                f"use backend='gloo')")
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_mesh_"))
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_child, args=(
                fn, rank, world, backend, device, str(tmp / "rendezvous"),
                timeout_s, args, str(tmp)), daemon=True)
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        grace = None    # after a first failure, the others' errors too
        while any(p.exitcode is None for p in procs):
            now = time.monotonic()
            if grace is None and any(p.exitcode not in (None, 0)
                                     for p in procs):
                grace = now + 2.0
            if grace is not None and now > grace:
                break
            if now > deadline:
                late = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise TimeoutError(f"ranks {late} of {world} did not finish "
                                   f"within {timeout_s} s")
            time.sleep(0.02)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed:
            errors = "\n".join(f"rank {r}:\n{_error_text(tmp, r, procs[r])}"
                               for r in failed)
            raise RuntimeError(f"ranks {failed} of {world} failed:\n{errors}")
        results = []
        for rank in range(world):
            path = tmp / f"result_{rank}.pt"
            results.append(torch.load(path, weights_only=False)
                           if path.exists() else None)
        return results
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)


def _error_text(tmp: Path, rank: int, proc) -> str:
    path = tmp / f"error_{rank}.txt"
    if path.exists():
        return path.read_text()
    return f"exit code {proc.exitcode}, no traceback"
