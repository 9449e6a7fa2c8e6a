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
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap, unembed
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


def loss_fn(params, cfg: ModelConfig, batch, *, use_kernel: bool = False):
    """(total = ce + aux, {"ce", "aux", "tokens"}): the mean next-token CE
    over the valid labels, plus the MoE load-balance loss.  The head is
    ``lm_head``, or ``embed`` when tied; a prefix model's hidden state is
    cut to the text positions.  ``use_kernel=True`` runs the forward
    through the kernels (under ``torch.no_grad()`` only: they are
    forward-only)."""
    hidden, aux = forward_features(params, cfg, batch["tokens"],
                                   use_kernel=use_kernel,
                                   **_frontend_kwargs(batch))
    labels = batch["labels"]
    if "prefix_embeds" in batch:
        # hidden spans [prefix, text]; supervise only the text positions
        hidden = hidden[:, batch["prefix_embeds"].shape[1]:]
    head = params.get("lm_head", params["embed"])
    nll_sum, n_valid = chunked_cross_entropy(head, cfg, hidden, labels)
    denom = torch.clamp(n_valid, min=1)
    ce = nll_sum / denom
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": denom}


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, metrics, grads) of ``loss_fn`` on the plain forward; the
    gradients come back in the parameters' tree.  The parameters are taken
    through detached aliases that ask for grad, so the caller's tensors
    keep their flags."""
    leaves = tree_leaves(params)
    alias = {id(p): p.detach().requires_grad_() for p in leaves}
    live = tree_map(lambda p: alias[id(p)], params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch, use_kernel=False)
        grads = torch.autograd.grad(loss, [alias[id(p)] for p in leaves],
                                    allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def loss_and_grads(params, cfg: ModelConfig, batch, microbatches: int = 1):
    """(loss, metrics, grads) of one batch.  With ``microbatches > 1`` the
    batch is split on its leading axis and run in turn: fp32 gradients
    accumulate as ``g / microbatches``, the loss and ce as averages the
    same way, ``aux`` is reported as loss - ce and ``tokens`` as the
    batch's token count, as the reference does."""
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch)
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    ce = torch.zeros_like(loss)
    for i in range(microbatches):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i, m_i, g_i = _value_and_grad(params, cfg, micro)
        for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
            acc.add_(g.float() / microbatches)
        del g_i
        loss = loss + l_i / microbatches
        ce = ce + m_i["ce"] / microbatches
    metrics = {"ce": ce, "aux": loss - ce,
               "tokens": torch.tensor(batch["tokens"].numel(),
                                      device=loss.device)}
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
