"""Training step: next-token cross-entropy and AdamW, family-aware batches
(the reference's ``training/steps.py``).

Batch layouts (as ``launch.shapes.input_specs`` gives them):
  dense/moe/ssm/hybrid: {tokens (B, S), labels (B, S)}
  vlm:   + prefix_embeds (B, P, d); labels cover only the text positions
  audio: + enc_embeds (B, F, d); tokens and labels are decoder text
Labels < 0 are ignored (padding).

The model runs with ``use_kernel=False``: the ``swa``, ``rglru`` and
``mlstm`` kernels are forward-only, as the TPU kernels they replace are, so
a training step differentiates their plain versions, as the reference's
training differentiates its jnp model code and reaches no Pallas kernel.
On CUDA tensors a step launches none of them.

Data parallelism: under ``models.sharding.use_mesh(mesh)`` each rank holds
its own rows of the global batch (row-major over the mesh's batch axes,
``("pod", "data")``, those it has), and ``loss_and_grads`` reduces over
those axes with ``Mesh.all_reduce``: the valid-label counts of the global
batch's microbatches first, so that every rank divides its summed nll by
the global count of the microbatch its rows belong to, then the gradients
and the loss.  The result is the CE and gradient of the global batch, as
the reference's GSPMD step computes them for a batch sharded over those
axes, microbatches included: the reference's microbatch i is the global
rows ``[i * B / M, (i + 1) * B / M)``, and a rank's own k-th microbatch
lies inside one of them (ranks hold different numbers of valid labels, so
a mean of the ranks' means would be another loss).  The MoE load-balance
term is the mean of the ranks' own, each computed on its rows.  Without a
mesh, or on a mesh without batch axes, there is one rank and a step is the
single-process step.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap, unembed
from repro_torch.models.sharding import BATCH_AXES, _active_mesh
from repro_torch.models.transformer import forward_features
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    tree_leaves,
    tree_map,
)


def _frontend_kwargs(batch: Dict[str, Any]) -> Dict[str, Any]:
    kw = {}
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if "enc_embeds" in batch:
        kw["enc_embeds"] = batch["enc_embeds"]
    return kw


def _ce_chunk(head, cfg: ModelConfig, h_c: torch.Tensor,
              labels_c: torch.Tensor):
    """CE terms of one sequence chunk, h_c (B, c, d), labels_c (B, c):
    (the summed nll, fp32; the count of valid labels).  The (B, c, V)
    logits are fp32 after the softcap and live only inside the chunk."""
    logits = softcap(unembed(head, h_c), cfg.logits_softcap)
    valid = labels_c >= 0
    labels_safe = torch.clamp(labels_c, min=0).long()
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(lf, -1, labels_safe[..., None])[..., 0]
    nll = torch.where(valid, lse - label_logit, 0.0)
    return nll.sum(), valid.sum()


def chunked_cross_entropy(head, cfg: ModelConfig, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 512):
    """Unembed and CE fused per sequence chunk of ``chunk`` positions (a
    ragged end padded with label -1): (the summed nll, the count of valid
    labels).  Each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``), so no (B, S, V) tensor is stored: a
    chunk's logits are recomputed in its backward."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        h_c, l_c = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            s, c = torch.utils.checkpoint.checkpoint(
                _ce_chunk, head, cfg, h_c, l_c, use_reentrant=False)
        else:
            s, c = _ce_chunk(head, cfg, h_c, l_c)
        tot, cnt = tot + s, cnt + c
    return tot, cnt


def _nll_and_aux(params, cfg: ModelConfig, batch, use_kernel: bool):
    """(the summed nll of the valid labels, their count, the MoE aux as an
    fp32 scalar) of ``batch``.  The head is ``lm_head``, or ``embed`` when
    tied; a prefix model's hidden state is cut to the text positions."""
    hidden, aux = forward_features(params, cfg, batch["tokens"],
                                   use_kernel=use_kernel,
                                   **_frontend_kwargs(batch))
    labels = batch["labels"]
    if "prefix_embeds" in batch:
        # hidden spans [prefix, text]; supervise only the text positions
        hidden = hidden[:, batch["prefix_embeds"].shape[1]:]
    head = params.get("lm_head", params["embed"])
    nll_sum, n_valid = chunked_cross_entropy(head, cfg, hidden, labels)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=nll_sum.device)
    return nll_sum, n_valid, aux


def loss_fn(params, cfg: ModelConfig, batch, *, use_kernel: bool = False):
    """(total = ce + aux, {"ce", "aux", "tokens"}): the mean next-token CE
    over the valid labels, plus the MoE load-balance loss.
    ``use_kernel=True`` runs the forward through the kernels (under
    ``torch.no_grad()`` only: they are forward-only)."""
    nll_sum, n_valid, aux = _nll_and_aux(params, cfg, batch, use_kernel)
    denom = torch.clamp(n_valid, min=1)
    ce = nll_sum / denom
    return ce + aux, {"ce": ce, "aux": aux, "tokens": denom}


def _value_and_grad(params, objective):
    """(loss, metrics, grads) of ``objective(params) -> (loss, metrics)``;
    the gradients come back in the parameters' tree.  The parameters are
    taken through detached aliases that ask for grad, so the caller's
    tensors keep their flags."""
    leaves = tree_leaves(params)
    alias = {id(p): p.detach().requires_grad_() for p in leaves}
    live = tree_map(lambda p: alias[id(p)], params)
    with torch.enable_grad():
        loss, metrics = objective(live)
        grads = torch.autograd.grad(loss, [alias[id(p)] for p in leaves],
                                    allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _microbatches(batch, microbatches: int) -> list:
    """``batch`` split on its leading axis into ``microbatches`` parts."""
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(microbatches)]


def _accumulated(params, objectives, microbatches: int):
    """(loss, {"ce", "aux"}, grads) of ``objectives`` (one a microbatch) run
    in turn: a single one's own, else fp32 gradients accumulated as ``g /
    microbatches``, the loss and ce averaged the same way and aux reported
    as loss - ce."""
    if microbatches == 1:
        return _value_and_grad(params, objectives[0])
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss = ce = None
    for objective in objectives:
        l_i, m_i, g_i = _value_and_grad(params, objective)
        for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
            acc.add_(g.float() / microbatches)
        del g_i
        if loss is None:
            loss = ce = torch.zeros_like(l_i)
        loss = loss + l_i / microbatches
        ce = ce + m_i["ce"] / microbatches
    return loss, {"ce": ce, "aux": loss - ce}, grads


def _batch_rank(mesh, axes: tuple) -> tuple[int, int]:
    """(the number of ranks over ``axes``, this rank's index among them,
    row-major in the mesh's order: the block of the global batch it
    holds)."""
    coords = dict(zip(mesh.axis_names, mesh.coords(mesh.rank)))
    n_ranks, index = 1, 0
    for a in axes:
        size = mesh.shape[a]
        n_ranks, index = n_ranks * size, index * size + coords[a]
    return n_ranks, index


def loss_and_grads(params, cfg: ModelConfig, batch, microbatches: int = 1):
    """(loss, metrics, grads) of one batch.  With ``microbatches > 1`` the
    batch is split on its leading axis and run in turn: fp32 gradients
    accumulate as ``g / microbatches``, the loss and ce as averages the
    same way, ``aux`` is reported as loss - ce and ``tokens`` as the
    batch's token count, as the reference does.  Under an active mesh with
    batch axes, ``batch`` is this rank's rows and the result is the global
    batch's (module docstring)."""
    mesh = _active_mesh()
    axes = () if mesh is None else tuple(
        a for a in BATCH_AXES if a in mesh.axis_names)
    n_ranks, index = _batch_rank(mesh, axes) if axes else (1, 0)
    micros = _microbatches(batch, microbatches)
    device = batch["labels"].device
    # this rank's k-th microbatch is global rows [(index M + k) mb, +mb):
    # part of the global batch's microbatch (index M + k) // n_ranks
    slot = torch.tensor([(index * microbatches + k) // n_ranks
                         for k in range(microbatches)], device=device)
    counts = torch.zeros(microbatches, dtype=torch.int64, device=device)
    counts.index_add_(0, slot, torch.stack([(m["labels"] >= 0).sum()
                                            for m in micros]))
    if axes:
        with torch.no_grad():
            counts = mesh.all_reduce(counts, axes)
    denoms = torch.clamp(counts, min=1)[slot]

    def objective(micro, denom):
        def fn(live):
            nll_sum, _, aux = _nll_and_aux(live, cfg, micro, False)
            ce, aux = nll_sum / denom, aux / n_ranks
            return ce + aux, {"ce": ce, "aux": aux}
        return fn

    loss, metrics, grads = _accumulated(
        params, [objective(m, d) for m, d in zip(micros, denoms)],
        microbatches)
    if axes:
        with torch.no_grad():
            grads = tree_map(lambda g: mesh.all_reduce(g, axes), grads)
            loss, ce = mesh.all_reduce(torch.stack([loss, metrics["ce"]]),
                                       axes).unbind()
        metrics = {"ce": ce, "aux": loss - ce}
    metrics["tokens"] = (denoms[0] if microbatches == 1 else torch.tensor(
        batch["tokens"].numel() * n_ranks, device=loss.device))
    return loss, metrics, grads


def train_step(params, opt_state, batch, cfg: ModelConfig,
               opt_cfg: AdamWConfig, microbatches: int = 1):
    """One optimizer step: (params, opt_state, metrics) with the loss, ce,
    aux, tokens, grad_norm (before clipping) and lr; the parameters and
    moments are updated in place (``adamw_update``).  With ``microbatches >
    1`` gradients accumulate over sequential microbatches (activation
    memory / microbatches)."""
    loss, metrics, grads = loss_and_grads(params, cfg, batch, microbatches)
    params, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    metrics["loss"] = loss
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """``train_step`` with the configs bound: step(params, opt_state,
    batch)."""

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, opt_cfg,
                          microbatches=microbatches)

    return step
