"""Model assembly: blocks, the layer stack, the train-mode forward passes
and backbone ``encode``, and the serving entry points ``prefill`` and
``decode_step``.

Parameters are nested dicts of fp32 tensors, as the reference's pytrees,
with one difference of layout: the reference stacks its full layer cycles
on a leading axis for ``lax.scan`` (``params["cycles"]``) and keeps the
remainder apart (``params["rem"]``); here ``params["layers"]`` is the flat
list in the reference's order, cycle c block j at index c * len(pattern) + j,
then the remainder (``convert.model_from_numpy`` unstacks).  Layer l has
kind ``cfg.layer_kinds()[l]``.  Caches follow the same flat layout
(``models/cache.py``).

Three modes share one block implementation, for the kinds ``attn``,
``swa``, ``rglru``, ``mlstm`` and ``slstm``:

  train   -- full sequence, no cache;
  prefill -- full sequence, and the block's cache entry: k and v written
             into their (ring) slots, or the recurrent state at the end;
  decode  -- one token, reading and updating the entry.

The kind ``moe``, encoder-decoder models and prefix embeddings raise
``NotImplementedError`` naming their slice.  ``models/sharding.py`` has
nothing to port on one device (its calls are no-ops without a mesh); the
multi-GPU slice brings it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.attention import (
    _qkv,
    attention_init,
    decode_attention,
    self_attention_block,
    self_attention_with_kv,
)
from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvquant import QuantizedKV, quantize, read_all, write_row
from repro_torch.models.layers import (
    compute_dtype,
    dense,
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

_LATER_KINDS = {"moe": "the MoE slice (MoE FFN)"}
_KINDS = ("attn", "swa", "rglru", "mlstm", "slstm")
_MODES = ("train", "prefill", "decode")


def _unsupported(cfg: ModelConfig, prefix_embeds=None, enc_embeds=None):
    if cfg.family == "audio" or cfg.is_encdec or enc_embeds is not None:
        raise NotImplementedError(
            "encoder-decoder models come with the encoder-decoder slice")
    if prefix_embeds is not None:
        raise NotImplementedError(
            "prefix embeddings come with the encoder-decoder slice")


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


def _entry_slots(entry) -> int:
    k = entry["k"]
    return (k.q if isinstance(k, QuantizedKV) else k).shape[1]


def _prefill_kv(entry, k: torch.Tensor, v: torch.Tensor, ring: bool):
    """Write a prompt's k and v (B, S, KV, D) into a fresh entry of
    ``init_cache`` in place: a full line takes positions 0..S-1, a ring of W
    slots the last min(S, W) positions p at slots p % W.  k and v are cast
    to the cache's dtype, or quantized into an int8 line (``kv_quant``)."""
    S, W = k.shape[1], _entry_slots(entry)
    if S > W and not ring:
        raise ValueError(f"a prompt of {S} tokens does not fit max_len {W}")
    keep = min(S, W)
    p0 = torch.arange(S - keep, S, device=k.device)
    slots = p0 % W
    for name, t in (("k", k), ("v", v)):
        line = entry[name]
        if isinstance(line, QuantizedKV):
            qt = quantize(t[:, p0])
            line.q[:, slots] = qt.q
            line.scale[:, slots] = qt.scale
        else:
            line[:, slots] = t[:, p0].to(line.dtype)
    return entry


def _decode_attention_block(params, cfg: ModelConfig, h: torch.Tensor, entry,
                            pos: torch.Tensor, window):
    """One token's self-attention against its cache entry: its k and v
    written at slot ``pos`` (a full line) or ``pos % W`` (a ring of W
    slots), in place, then ``decode_attention`` over the valid slots."""
    B = h.shape[0]
    q, k_new, v_new = _qkv(params, cfg, h, pos[:, None])
    S = _entry_slots(entry)
    slots = torch.arange(S, device=h.device)[None]
    bidx = torch.arange(B, device=h.device)
    if window is None:
        # a position past the line is dropped, as the reference's scatter
        # drops it (the engine's idle slots run on past max_len)
        inside = pos < S
        slot = torch.clamp(pos, max=S - 1).long()
        valid = slots <= pos[:, None]
    else:
        inside = None
        slot = (pos % S).long()
        valid = slots < torch.clamp(pos + 1, max=S)[:, None]
    out_kv = []
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
        line = entry[name]
        if isinstance(line, QuantizedKV):
            write_row(line, bidx, slot, new, keep=inside)
            out_kv.append(read_all(line, q.dtype))
        else:
            new = new.to(line.dtype)
            if inside is not None:
                new = torch.where(inside[:, None, None], new, line[bidx, slot])
            line[bidx, slot] = new
            out_kv.append(line)
    out = decode_attention(q, out_kv[0], out_kv[1], valid, cfg.attn_softcap)
    return dense(params["wo"], out.reshape(B, 1, -1))


def mixer(params, cfg: ModelConfig, kind: str, h: torch.Tensor, *,
          mode: str = "train", positions=None, entry=None, pos=None,
          use_kernel: bool = True):
    """A block's sequence mixer on its normed input ``h`` (B, S, d), in any
    of the three modes: (out, new_entry), new_entry None in train mode.  It
    is the part of the block that runs a kernel (``swa``, ``rglru``,
    ``mlstm``; the sLSTM's step loop has none).  ``block_apply`` says what
    ``mode``, ``positions``, ``entry`` and ``pos`` mean; ``use_kernel=False``
    runs the kernels' plain versions on any device."""
    if kind in ("attn", "swa"):
        window = cfg.sliding_window if kind == "swa" else None
        if mode == "train":
            return self_attention_block(params["attn"], cfg, h, positions,
                                        window=window,
                                        use_kernel=use_kernel), None
        if mode == "prefill":
            a, k, v = self_attention_with_kv(params["attn"], cfg, h,
                                             window=window,
                                             use_kernel=use_kernel)
            return a, _prefill_kv(entry, k, v, ring=window is not None)
        return _decode_attention_block(params["attn"], cfg, h, entry, pos,
                                       window), entry
    state = entry if mode == "decode" else None
    if kind == "mlstm":
        a, new_entry = mlstm_block(params["mlstm"], cfg, h, state,
                                   use_kernel=use_kernel,
                                   final_state=mode == "prefill")
    elif kind == "slstm":
        a, new_entry = slstm_block(params["slstm"], cfg, h, state)
    else:
        a, new_entry = rglru_block(params["rglru"], cfg, h, state,
                                   use_kernel=use_kernel)
    return a, (None if mode == "train" else new_entry)


def block_apply(params, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                mode: str = "train", positions=None, entry=None, pos=None,
                use_kernel: bool = True):
    """One block: the residual mixer, then (all but the xLSTM blocks, which
    carry their own projections) the residual MLP.  Returns (x, new_entry,
    aux = 0), the reference's triple.

    ``mode="train"``: ``positions=None`` means ``arange(S)`` (windowed
    blocks then run the ``swa`` kernel); new_entry is None.
    ``mode="prefill"``: positions ``arange(S)``; ``entry`` is the block's
    fresh entry of ``init_cache``, filled in place (attention), or replaced
    by the recurrent state after the last step.  ``mode="decode"``: x is
    (B, 1, d), ``pos`` (B,) its positions, ``entry`` the live entry (KV
    lines are written in place; recurrent states come back new).
    ``use_kernel=False`` runs the ``swa``, ``rglru`` and ``mlstm`` kernels'
    plain versions on any device."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _kind_supported(kind)
    if mode != "train" and entry is None:
        raise ValueError(f"mode {mode!r} needs the block's cache entry")
    a, new_entry = mixer(params, cfg, kind,
                         rmsnorm(params["ln1"], x, cfg.norm_eps), mode=mode,
                         positions=positions, entry=entry, pos=pos,
                         use_kernel=use_kernel)
    x = x + a
    if kind not in ("mlstm", "slstm"):
        x = x + mlp(params["mlp"], cfg,
                    rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, new_entry, 0.0


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
                 use_kernel: bool = True, *, mode: str = "train", cache=None,
                 pos=None):
    """Every layer in order: (x, the new cache entries, all None in train
    mode)."""
    kinds = cfg.layer_kinds()
    if len(params["layers"]) != len(kinds):
        raise ValueError(
            f"params hold {len(params['layers'])} layers, cfg "
            f"{cfg.name!r} has {len(kinds)}")
    entries = [None] * len(kinds) if cache is None else cache["layers"]
    new_entries = []
    for layer, kind, entry in zip(params["layers"], kinds, entries):
        x, ne, _ = block_apply(layer, cfg, kind, x, mode=mode, entry=entry,
                               pos=pos, use_kernel=use_kernel)
        new_entries.append(ne)
    return x, new_entries


def forward_features(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                     prefix_embeds=None, enc_embeds=None,
                     use_kernel: bool = True):
    """Train-mode forward up to the final norm: ((B, S, d) hidden, aux).
    ``use_kernel=False`` runs the kernels' plain versions on any device."""
    _unsupported(cfg, prefix_embeds, enc_embeds)
    x, _ = _stack_apply(params, cfg, _embed_tokens(params, cfg, tokens),
                        use_kernel)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), 0.0


def head_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The (soft-capped) unembedding of final-norm hidden states: fp32
    logits."""
    head = params.get("lm_head", params["embed"])
    return softcap(unembed(head, x), cfg.logits_softcap)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, enc_embeds=None, use_kernel: bool = True):
    """Train-mode forward.  Returns (logits fp32 (B, S, vocab), aux)."""
    x, aux = forward_features(params, cfg, tokens,
                              prefix_embeds=prefix_embeds,
                              enc_embeds=enc_embeds, use_kernel=use_kernel)
    return head_logits(params, cfg, x), aux


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


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then ``head_logits``."""
    return head_logits(params, cfg,
                       rmsnorm(params["final_norm"], x, cfg.norm_eps))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int, *,
            prefix_embeds=None, enc_embeds=None, cache_dtype=torch.bfloat16,
            use_kernel: bool = True):
    """Process the prompts ``tokens`` (B, S), S <= max_len.  Returns (the
    last position's logits (B, 1, vocab) fp32, the cache at pos = S).

    The cache (``models.cache.init_cache``) lives on the tokens' device: KV
    lines of ``max_len`` slots and rings of ``min(sliding_window,
    max_len)`` in ``cache_dtype`` (bf16 by default, as in the reference,
    also for fp32 compute; int8 lines with ``cfg.kv_quant``), recurrent
    states in fp32.  Every ``swa`` block runs the ``swa`` kernel, every
    ``rglru`` block the ``rglru`` kernel and every mLSTM block the ``mlstm``
    kernel on the card (``use_kernel=False``: their plain versions)."""
    _unsupported(cfg, prefix_embeds, enc_embeds)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, cache_dtype, device=tokens.device)
    x, layers = _stack_apply(params, cfg, _embed_tokens(params, cfg, tokens),
                             use_kernel, mode="prefill", cache=cache)
    cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device),
             "layers": layers}
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
                use_kernel: bool = True):
    """One decode step: tokens (B, 1) at positions ``cache["pos"]``.
    Returns (logits (B, 1, vocab) fp32, the cache at pos + 1).

    The step consumes ``cache``: its KV lines are written in place and the
    returned cache holds them, beside the new recurrent states.  Every
    ``rglru`` block launches the ``rglru`` kernel (S = 1) on the card; the
    attention against the cache and the mLSTM and sLSTM steps are plain
    torch."""
    _unsupported(cfg)
    pos = cache["pos"]
    x, layers = _stack_apply(params, cfg, _embed_tokens(params, cfg, tokens),
                             use_kernel, mode="decode", cache=cache, pos=pos)
    return _logits(params, cfg, x), {"pos": pos + 1, "layers": layers}


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
