"""Mixture-of-Experts FFN: a top-k router and capacity-bounded scatter
dispatch, the reference's single-device formulation.

Each (token, k) assignment's position within its expert comes from a
cumulative sum over the flattened (S * K) axis, token-major, per batch row;
assignments at positions below the capacity C (``_capacity``) take slot
``expert * C + position`` of a dense (E * C, d) buffer, the others go to
an overflow row E * C that is dropped.  The experts' SwiGLU runs as one
batched product over experts, and each token adds its kept assignments'
outputs back with its renormalized gate weights.  Routing is per batch
row: a row's output depends on that row alone.

The router, the dispatch, the expert products and the combine are plain
tensor ops, as the reference computes them in jnp outside any Pallas
kernel.  ``moe_ffn_shardmap`` is the explicit expert-parallel schedule,
which ``moe_ffn`` takes (as the reference does) only for ``moe_impl =
"shardmap"`` under an active mesh (``models.sharding.use_mesh``): each rank
computes its rows' share of an F slice of the experts and one all-reduce
over the ``model`` axis sums them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.sharding import MODEL_AXIS, _active_mesh


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in = (1.0 / d) ** 0.5
    s_out = (1.0 / f) ** 0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)

    return {
        "router": dense_init(gen, d, e),
        "w_gate": {"w": normal((e, d, f), s_in)},
        "w_up": {"w": normal((e, d, f), s_in)},
        "w_down": {"w": normal((e, f, d), s_out)},
    }


def _capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert for a row of ``s`` tokens: the reference's Python
    float expression, truncated by ``int``, at least K."""
    c = int(s * cfg.n_experts_active / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.n_experts_active)


def _router(params, cfg: ModelConfig, x: torch.Tensor):
    """(probs (B, S, E) fp32, top_p (B, S, K) renormalized, top_e (B, S, K)).

    The logits are x's dtype's products summed in fp32 (the reference's
    ``preferred_element_type=float32`` einsum): x and the router weights
    rounded to x's dtype, then multiplied in fp32.  A stable descending
    sort puts the lower expert first among equal probabilities, as
    ``lax.top_k`` does."""
    w = params["router"]["w"].to(x.dtype)
    logits = x.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.n_experts_active
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _route(params, cfg: ModelConfig, x: torch.Tensor):
    """Router and capacity bookkeeping: (slot (B, S, K) int64, top_p, keep
    (B, S, K) bool, aux (fp32 scalar), C)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    C = _capacity(cfg, S)
    probs, top_p, top_e = _router(params, cfg, x)
    # position of each (token, k) assignment within its expert, per batch
    # row, counted over the token-major (S * K) axis.  The int64 cumsum is
    # (B, S * K, E): 268 MB at B 8, S 4096, K 8, E 128
    flat_e = top_e.reshape(B, S * K)
    onehot = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_e = torch.gather(pos, 2, flat_e[..., None]).reshape(B, S, K)
    del onehot, pos
    keep = pos_in_e < C
    slot = torch.where(keep, top_e * C + pos_in_e,
                       torch.full_like(top_e, E * C))
    # every assignment counts, kept or dropped: averaged over (S, K), then B
    frac_tokens = F.one_hot(top_e, E).float().mean(dim=(1, 2)).mean(0)
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_weight
    return slot, top_p, keep, aux, C


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, d).  Returns (out, aux): ``moe_ffn_shardmap``'s block of
    the output for ``cfg.moe_impl == "shardmap"`` under an active mesh,
    else ``moe_ffn_gspmd``'s (B, S, d) in x's dtype (every ``moe_impl`` on
    one device, as the reference runs without a mesh)."""
    if cfg.moe_impl == "shardmap" and _active_mesh() is not None:
        return moe_ffn_shardmap(params, cfg, x)
    return moe_ffn_gspmd(params, cfg, x)


def _swiglu_experts(params, x: torch.Tensor) -> torch.Tensor:
    """(B, E, C, d) expert buffers -> (B, E, C, d): each expert's SwiGLU,
    one batched product over experts, weights cast to x's dtype."""
    wg = params["w_gate"]["w"].to(x.dtype)
    wu = params["w_up"]["w"].to(x.dtype)
    wd = params["w_down"]["w"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", x, wg)) * torch.einsum(
        "becd,edf->becf", x, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def moe_ffn_gspmd(params, cfg: ModelConfig, x: torch.Tensor):
    """The single-device formulation: scatter the (token, k) copies into
    (E * C + 1) rows a batch row (the overflow row last, written by every
    dropped assignment and then discarded; every kept slot is unique, so
    the kept rows are deterministic), the experts' SwiGLU on the (B, E, C,
    d) buffers, then gather each assignment's row back and combine it with
    its gate weight rounded to x's dtype."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    slot, top_p, keep, aux, C = _route(params, cfg, x)
    bidx = torch.arange(B, device=x.device)[:, None]
    flat_slot = slot.reshape(B, S * K)
    buf = x.new_zeros((B, E * C + 1, d))
    buf[bidx, flat_slot] = x.repeat_interleave(K, dim=1)
    out_buf = _swiglu_experts(params, buf[:, :E * C].reshape(B, E, C, d))
    out_flat = torch.cat([out_buf.reshape(B, E * C, d),
                          x.new_zeros((B, 1, d))], dim=1)
    gathered = out_flat[bidx, flat_slot].reshape(B, S, K, d)
    w = (top_p * keep).to(x.dtype)
    return torch.einsum("bskd,bsk->bsd", gathered, w), aux


def _shard_rows(mesh, batch_axes, B: int) -> slice:
    """This rank's block of B batch rows: B split evenly over the data axes,
    block index the row-major flattening of the rank's coordinates on them
    (the reference's ``P(("pod", "data"), ...)``)."""
    coords = dict(zip(mesh.axis_names, mesh.coords(mesh.rank)))
    n, idx = 1, 0
    for a in batch_axes:
        n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
    if B % n:
        raise ValueError(f"batch {B} does not split over the data axes "
                         f"{batch_axes} ({n} shards)")
    return slice(idx * (B // n), (idx + 1) * (B // n))


def moe_ffn_shardmap(params, cfg: ModelConfig, x: torch.Tensor):
    """The reference's explicit per-model-shard expert schedule, one rank of
    it.  Every rank of the active mesh calls it with the whole (B, S, d)
    input and whole fp32 weights, and returns (its block (B / n_data, S,
    d / n_model) of the output, the reference's ``out_specs = P(batch,
    None, "model")``, and aux).

    Routing is computed on the whole batch on every rank (replicated, as
    the reference's routing metadata), so aux is ``_route``'s.  The rank
    then takes its batch rows (by its coordinates on the data axes) at full
    d and an F slice of ``w_gate``, ``w_up`` and ``w_down`` (by its
    ``model`` coordinate): dispatch, gate/up and the SiLU are local, the
    down-projection is partial over F, and its reduction is deferred past
    the (linear) gather and combine, so that the sum over ``model`` moves
    the (B, S, d) token tensor rather than the (B, E, C, d) expert buffer:
    one ``Mesh.all_reduce`` over ``model``, then this rank's d slice (the
    reference's ``_rscatter``: ``psum`` and a slice).  Differentiable: the
    gradient of a weight on a rank covers its F slice and its rows; summed
    over the mesh, it is the whole-batch gradient."""
    mesh = _active_mesh()
    if mesh is None:
        raise ValueError("moe_ffn_shardmap runs under an active mesh "
                         "(models.sharding.use_mesh)")
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"moe_ffn_shardmap needs a {MODEL_AXIS!r} axis, the "
                         f"mesh has {mesh.axis_names}")
    B, S, d = x.shape
    E, K, F_ = cfg.n_experts, cfg.n_experts_active, cfg.moe_d_ff
    slot, top_p, keep, aux, C = _route(params, cfg, x)
    comb = (top_p * keep).to(x.dtype)
    n = mesh.shape[MODEL_AXIS]
    j = mesh.coords(mesh.rank)[mesh.axis_names.index(MODEL_AXIS)]
    if F_ % n or d % n:
        raise ValueError(f"moe_d_ff {F_} and d_model {d} must split over "
                         f"{n} {MODEL_AXIS!r} shards")
    fs = slice(j * (F_ // n), (j + 1) * (F_ // n))
    rows = _shard_rows(mesh, [a for a in ("pod", "data")
                              if a in mesh.axis_names], B)
    x_l, slot_l, comb_l = x[rows], slot[rows], comb[rows]
    Bl = x_l.shape[0]
    wg = params["w_gate"]["w"][:, :, fs].to(x.dtype)
    wu = params["w_up"]["w"][:, :, fs].to(x.dtype)
    wd = params["w_down"]["w"][:, fs].to(x.dtype)
    bidx = torch.arange(Bl, device=x.device)[:, None]
    flat_slot = slot_l.reshape(Bl, S * K)
    buf = x_l.new_zeros((Bl, E * C + 1, d))
    buf[bidx, flat_slot] = x_l.repeat_interleave(K, dim=1)
    buf = buf[:, :E * C].reshape(Bl, E, C, d)
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum(
        "becd,edf->becf", buf, wu)                         # (Bl, E, C, F/n)
    out_part = torch.einsum("becf,efd->becd", h, wd)       # partial over F
    out_flat = torch.cat([out_part.reshape(Bl, E * C, d),
                          x_l.new_zeros((Bl, 1, d))], dim=1)
    gathered = out_flat[bidx, flat_slot].reshape(Bl, S, K, d)
    partial = torch.einsum("bskd,bsk->bsd", gathered, comb_l)
    summed = mesh.all_reduce(partial, MODEL_AXIS)
    return summed[..., j * (d // n):(j + 1) * (d // n)], aux


def moe_ffn_by_expert(params, cfg: ModelConfig, x: torch.Tensor):
    """A plain per-expert version of ``moe_ffn``, for checks only (the
    tests and ``chip_smoke.py`` hold ``moe_ffn`` against it; nothing on
    the main path calls it).  For each expert it takes the (token, k)
    assignments that ``_route`` kept for that expert, runs that expert's
    SwiGLU on their tokens, and writes the outputs at (b, s, k); the
    combine is the same weighted sum over k.  It shares the router and the
    keep mask with ``moe_ffn``, but no slot, buffer, scatter or gather.
    Returns (out, aux)."""
    B, S, d = x.shape
    K = cfg.n_experts_active
    _, top_p, top_e = _router(params, cfg, x)
    _, _, keep, aux, _ = _route(params, cfg, x)
    contrib = x.new_zeros((B, S, K, d))
    for e in range(cfg.n_experts):
        b, s, k = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if b.numel() == 0:
            continue
        xs = x[b, s]
        h = F.silu(xs @ params["w_gate"]["w"][e].to(x.dtype)) * (
            xs @ params["w_up"]["w"][e].to(x.dtype))
        contrib[b, s, k] = h @ params["w_down"]["w"][e].to(x.dtype)
    w = (top_p * keep).to(x.dtype)
    return torch.einsum("bskd,bsk->bsd", contrib, w), aux
