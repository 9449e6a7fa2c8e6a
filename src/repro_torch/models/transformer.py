"""Model assembly: blocks, the layer stack, and the train-mode forward
passes and backbone ``encode``.

Parameters are nested dicts of fp32 tensors, as the reference's pytrees,
with one difference of layout: the reference stacks its full layer cycles
on a leading axis for ``lax.scan`` (``params["cycles"]``) and keeps the
remainder apart (``params["rem"]``); here ``params["layers"]`` is the flat
list in the reference's order, cycle c block j at index c * len(pattern) + j,
then the remainder (``convert.model_from_numpy`` unstacks).  Layer l has
kind ``cfg.layer_kinds()[l]``.

Ported: mode ``"train"`` for the kinds ``attn``, ``swa``, ``rglru``,
``mlstm`` and ``slstm``.  The kind ``moe``, prefill and decode,
encoder-decoder models and prefix embeddings raise ``NotImplementedError``
naming their slice.  ``models/sharding.py`` has nothing to port on one device (its calls
are no-ops without a mesh); the multi-GPU slice brings it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.attention import attention_init, self_attention_block
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    compute_dtype,
    embed,
    embedding_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
    unembed,
)
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.rglru import rglru_block, rglru_init
from repro_torch.models.xlstm import (
    mlstm_block,
    mlstm_init,
    slstm_block,
    slstm_init,
)

_LATER_KINDS = {"moe": "the LM-substrate slice (MoE FFN)"}
_KINDS = ("attn", "swa", "rglru", "mlstm", "slstm")


def _unsupported(cfg: ModelConfig, prefix_embeds=None, enc_embeds=None):
    if cfg.family == "audio" or cfg.is_encdec or enc_embeds is not None:
        raise NotImplementedError(
            "encoder-decoder models come with the LM-substrate slice")
    if prefix_embeds is not None:
        raise NotImplementedError(
            "prefix embeddings come with the LM-substrate slice")


def _kind_supported(kind: str) -> None:
    if kind in _LATER_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; it comes with "
            f"{_LATER_KINDS[kind]}")
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind}")


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str):
    _kind_supported(kind)
    dev = gen.device
    p: dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, dev)}
    # xLSTM blocks carry their own projections: no ln2, no MLP
    if kind == "mlstm":
        p["mlstm"] = mlstm_init(gen, cfg)
        return p
    if kind == "slstm":
        p["slstm"] = slstm_init(gen, cfg)
        return p
    if kind == "rglru":
        p["rglru"] = rglru_init(gen, cfg)
    else:
        p["attn"] = attention_init(gen, cfg)
    p["ln2"] = rmsnorm_init(cfg.d_model, dev)
    p["mlp"] = mlp_init(gen, cfg)
    return p


def mixer(params, cfg: ModelConfig, kind: str, h: torch.Tensor, *,
          positions=None, use_kernel: bool = True) -> torch.Tensor:
    """A block's sequence mixer on its normed input ``h`` (B, S, d): the
    part of the block that runs a kernel (``swa``, ``rglru``, ``mlstm``;
    the sLSTM's step loop has none).  ``use_kernel=False`` runs the
    kernels' plain versions on any device."""
    if kind == "mlstm":
        return mlstm_block(params["mlstm"], cfg, h, use_kernel=use_kernel)
    if kind == "slstm":
        return slstm_block(params["slstm"], cfg, h)
    if kind == "rglru":
        return rglru_block(params["rglru"], cfg, h, use_kernel=use_kernel)[0]
    window = cfg.sliding_window if kind == "swa" else None
    return self_attention_block(params["attn"], cfg, h, positions,
                                window=window, use_kernel=use_kernel)


def block_apply(params, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                mode: str = "train", positions=None, use_kernel: bool = True):
    """One block in train mode: the residual mixer, then (all but the xLSTM
    blocks, which carry their own projections) the residual MLP.
    ``positions=None`` means ``arange(S)`` (windowed blocks then run the
    ``swa`` kernel).  ``use_kernel=False`` runs the ``swa``, ``rglru`` and
    ``mlstm`` kernels' plain versions on any device.  Returns (x, new_entry
    = None, aux = 0), the reference's triple."""
    if mode != "train":
        raise NotImplementedError(
            f"mode {mode!r} (KV and recurrent caches) comes with the serving "
            f"slice")
    _kind_supported(kind)
    x = x + mixer(params, cfg, kind, rmsnorm(params["ln1"], x, cfg.norm_eps),
                  positions=positions, use_kernel=use_kernel)
    if kind not in ("mlstm", "slstm"):
        x = x + mlp(params["mlp"], cfg,
                    rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, None, 0.0


def init_model(gen: torch.Generator | int, cfg: ModelConfig, device=None):
    """Random fp32 weights, drawn on the generator's device (an int seeds a
    new generator on ``device``, default ``cuda``)."""
    _unsupported(cfg)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device or "cuda").manual_seed(int(gen))
    kinds = cfg.layer_kinds()
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        "layers": [block_init(gen, cfg, kind) for kind in kinds],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    return params


def embed_scale(cfg: ModelConfig, dtype: torch.dtype):
    """Gemma-family models scale embeddings by sqrt(d_model) rounded to the
    compute dtype (the reference's ``jnp.asarray(d ** 0.5, dtype)``: 50.5 in
    bf16 at d = 2560); None for the others."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        return torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return None


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    dtype = compute_dtype(cfg)
    x = embed(params["embed"], tokens, dtype)
    scale = embed_scale(cfg, dtype)
    if scale is not None:
        x = x * scale.to(x.device)
    return x


def _stack_apply(params, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: bool = True):
    kinds = cfg.layer_kinds()
    if len(params["layers"]) != len(kinds):
        raise ValueError(
            f"params hold {len(params['layers'])} layers, cfg "
            f"{cfg.name!r} has {len(kinds)}")
    for layer, kind in zip(params["layers"], kinds):
        x, _, _ = block_apply(layer, cfg, kind, x, mode="train",
                              use_kernel=use_kernel)
    return x


def forward_features(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                     prefix_embeds=None, enc_embeds=None,
                     use_kernel: bool = True):
    """Train-mode forward up to the final norm: ((B, S, d) hidden, aux).
    ``use_kernel=False`` runs the kernels' plain versions on any device."""
    _unsupported(cfg, prefix_embeds, enc_embeds)
    x = _stack_apply(params, cfg, _embed_tokens(params, cfg, tokens),
                     use_kernel)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), 0.0


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, enc_embeds=None, use_kernel: bool = True):
    """Train-mode forward.  Returns (logits fp32 (B, S, vocab), aux)."""
    x, aux = forward_features(params, cfg, tokens,
                              prefix_embeds=prefix_embeds,
                              enc_embeds=enc_embeds, use_kernel=use_kernel)
    head = params.get("lm_head", params["embed"])
    return softcap(unembed(head, x), cfg.logits_softcap), aux


@torch.no_grad()
def encode(params, cfg: ModelConfig, tokens: torch.Tensor, *,
           prefix_embeds=None, enc_embeds=None,
           use_kernel: bool = True) -> torch.Tensor:
    """Backbone features: final-norm hidden states (B, S, d), no unembed.

    The feature map h(X) of the paper's technique at scale: the frozen
    backbone is the ELM's random hidden layer, and the multi-task head
    learns (U, A_t) on top of these features.  Inference only;
    ``use_kernel=False`` runs the kernels' plain versions on any device."""
    return forward_features(params, cfg, tokens, prefix_embeds=prefix_embeds,
                            enc_embeds=enc_embeds, use_kernel=use_kernel)[0]


def prefill(*args, **kwargs):
    raise NotImplementedError("prefill comes with the serving slice")


def decode_step(*args, **kwargs):
    raise NotImplementedError("decode_step comes with the serving slice")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))
