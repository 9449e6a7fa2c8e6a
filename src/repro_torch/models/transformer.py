"""Model assembly: blocks, the layer stack, the train-mode forward passes
and backbone ``encode``, and the serving entry points ``prefill`` and
``decode_step``.

Parameters are nested dicts of fp32 tensors, as the reference's pytrees,
with one difference of layout: the reference stacks its full layer cycles
on a leading axis for ``lax.scan`` (``params["cycles"]``) and keeps the
remainder apart (``params["rem"]``); here ``params["layers"]`` is the flat
list in the reference's order, cycle c block j at index c * len(pattern) + j,
then the remainder, and an encoder-decoder's ``params["encoder"]`` the list
of its ``n_enc_layers`` blocks (the reference stacks them too;
``convert.model_from_numpy`` unstacks).  Layer l has kind
``cfg.layer_kinds()[l]``.  Caches follow the same flat layout
(``models/cache.py``).

Three modes share one block implementation, for the kinds ``attn``,
``swa``, ``moe``, ``rglru``, ``mlstm`` and ``slstm``:

  train   -- full sequence, no cache;
  prefill -- full sequence, and the block's cache entry: k and v written
             into their (ring) slots, or the recurrent state at the end,
             and an encoder-decoder's cross-attention k and v of the
             encoder memory;
  decode  -- one token, reading and updating the entry.

Prefix embeddings (a VLM's patches) go before the token embeddings, after
the Gemma scale; an encoder-decoder (``cfg.is_encdec``) runs its encoder
over ``enc_embeds`` once, and every attention block of the decoder attends
to the encoder's memory after its self-attention.  The ``audio`` family
normalizes with LayerNorm, every other with RMSNorm.  ``models/sharding.py``
has nothing to run on one device (its calls are no-ops without a mesh).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.models.attention import (
    _qkv,
    attention_init,
    cross_attention_block,
    cross_free_self_attention,
    cross_kv,
    cross_query,
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
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
    unembed,
)
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.models.rglru import rglru_block, rglru_init
from repro_torch.models.xlstm import (
    mlstm_block,
    mlstm_init,
    slstm_block,
    slstm_init,
)

_KINDS = ("attn", "swa", "moe", "rglru", "mlstm", "slstm")
_ATTN_KINDS = ("attn", "swa", "moe")
_MODES = ("train", "prefill", "decode")


def _norm_init(cfg: ModelConfig, device):
    if cfg.family == "audio":
        return layernorm_init(cfg.d_model, device)
    return rmsnorm_init(cfg.d_model, device)


def _norm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    fn = layernorm if cfg.family == "audio" else rmsnorm
    return fn(params, x, cfg.norm_eps)


def _kind_known(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind}")


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               with_cross: bool = False):
    """One block's weights; ``with_cross`` adds an attention block's
    cross-attention (``ln_cross``, ``cross``) of an encoder-decoder."""
    _kind_known(kind)
    dev = gen.device
    p: dict[str, Any] = {"ln1": _norm_init(cfg, dev)}
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
    p["ln2"] = _norm_init(cfg, dev)
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    if with_cross and kind in _ATTN_KINDS:
        p["ln_cross"] = _norm_init(cfg, dev)
        p["cross"] = attention_init(gen, cfg, cross=True)
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
          causal: bool = True, use_kernel: bool = True):
    """A block's sequence mixer on its normed input ``h`` (B, S, d), in any
    of the three modes: (out, new_entry), new_entry None in train mode.  It
    is the part of the block that runs a kernel (``swa``, ``rglru``,
    ``mlstm``; the sLSTM's step loop and global attention have none).
    ``block_apply`` says what ``mode``, ``positions``, ``entry``, ``pos``
    and ``causal`` mean; ``use_kernel=False`` runs the kernels' plain
    versions on any device."""
    if kind in _ATTN_KINDS:
        window = cfg.sliding_window if kind == "swa" else None
        if mode == "train":
            if not causal:
                return cross_free_self_attention(params["attn"], cfg, h,
                                                 positions), None
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


def _cross_branch(params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                  entry, memory):
    """An encoder-decoder block's cross-attention over the encoder memory,
    after its self-attention: (out, entry).  Train mode and prefill attend
    to every frame of ``memory`` (B, F, d), and prefill writes its cross k
    and v into the entry's ``ck`` and ``cv`` (F slots, whatever the entry's
    length, in the entry's dtype); decode attends to every slot of ``ck``
    and ``cv``."""
    hc = _norm(cfg, params["ln_cross"], x)
    if mode == "decode":
        B = x.shape[0]
        q = cross_query(params["cross"], cfg, hc)
        valid = torch.ones((B, entry["ck"].shape[1]), dtype=torch.bool,
                           device=x.device)
        o = decode_attention(q, entry["ck"], entry["cv"], valid,
                             cfg.attn_softcap)
        return dense(params["cross"]["wo"], o.reshape(B, 1, -1)), entry
    if memory is None:
        raise ValueError("an encoder-decoder block needs the encoder memory "
                         "(enc_embeds)")
    c = cross_attention_block(params["cross"], cfg, hc, memory)
    if mode == "prefill":
        ck, cv = cross_kv(params["cross"], cfg, memory)
        entry["ck"] = ck.to(entry["ck"].dtype)
        entry["cv"] = cv.to(entry["cv"].dtype)
    return c, entry


def block_apply(params, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                mode: str = "train", positions=None, entry=None, pos=None,
                memory=None, causal: bool = True, use_kernel: bool = True):
    """One block: the residual mixer, an encoder-decoder's residual
    cross-attention, then (all but the xLSTM blocks, which carry their own
    projections) the residual MLP or MoE FFN.  Returns (x, new_entry, aux),
    aux the MoE's load-balance loss (fp32 scalar) and 0.0 for the others.

    ``mode="train"``: ``positions=None`` means ``arange(S)`` (windowed
    blocks then run the ``swa`` kernel); ``causal=False`` makes an
    attention block bidirectional (the encoder's); new_entry is None.
    ``mode="prefill"``: positions ``arange(S)``; ``entry`` is the block's
    fresh entry of ``init_cache``, filled in place (attention), or replaced
    by the recurrent state after the last step.  ``mode="decode"``: x is
    (B, 1, d), ``pos`` (B,) its positions, ``entry`` the live entry (KV
    lines are written in place; recurrent states come back new).
    ``memory`` (B, F, d) is an encoder-decoder's encoder output (train and
    prefill).
    ``use_kernel=False`` runs the ``swa``, ``rglru`` and ``mlstm`` kernels'
    plain versions on any device."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _kind_known(kind)
    if mode != "train" and entry is None:
        raise ValueError(f"mode {mode!r} needs the block's cache entry")
    a, new_entry = mixer(params, cfg, kind, _norm(cfg, params["ln1"], x),
                         mode=mode, positions=positions, entry=entry, pos=pos,
                         causal=causal, use_kernel=use_kernel)
    x = x + a
    if "cross" in params:
        c, new_entry = _cross_branch(params, cfg, x, mode=mode,
                                     entry=new_entry, memory=memory)
        x = x + c
    aux = 0.0
    if kind == "moe":
        f, aux = moe_ffn(params["moe"], cfg, _norm(cfg, params["ln2"], x))
        x = x + f
    elif kind not in ("mlstm", "slstm"):
        x = x + mlp(params["mlp"], cfg, _norm(cfg, params["ln2"], x))
    return x, new_entry, aux


def init_model(gen: torch.Generator | int, cfg: ModelConfig, device=None):
    """Random fp32 weights, drawn on the generator's device (an int seeds a
    new generator on ``device``, default ``cuda``)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device or "cuda").manual_seed(int(gen))
    kinds = cfg.layer_kinds()
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": _norm_init(cfg, gen.device),
        "layers": [block_init(gen, cfg, kind, cfg.is_encdec)
                   for kind in kinds],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    if cfg.is_encdec:
        params["encoder"] = [block_init(gen, cfg, "attn")
                             for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = _norm_init(cfg, gen.device)
    return params


def embed_scale(cfg: ModelConfig, dtype: torch.dtype):
    """Gemma-family models scale embeddings by sqrt(d_model) rounded to the
    compute dtype (the reference's ``jnp.asarray(d ** 0.5, dtype)``: 50.5 in
    bf16 at d = 2560); None for the others."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        return torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return None


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeds=None):
    """Token embeddings in the compute dtype (Gemma-scaled), after
    ``prefix_embeds`` (B, P, d) cast to it when given: (B, P + S, d)."""
    dtype = compute_dtype(cfg)
    x = embed(params["embed"], tokens, dtype)
    scale = embed_scale(cfg, dtype)
    if scale is not None:
        x = x * scale.to(x.device)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    return x


def run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """An encoder-decoder's encoder: ``enc_embeds`` (B, F, d) cast to the
    compute dtype, through its bidirectional ``attn`` blocks, then
    ``enc_norm``: the memory (B, F, d)."""
    x = enc_embeds.to(compute_dtype(cfg))
    for layer in params["encoder"]:
        x, _, _ = block_apply(layer, cfg, "attn", x, causal=False,
                              use_kernel=use_kernel)
    return _norm(cfg, params["enc_norm"], x)


def _memory(params, cfg: ModelConfig, enc_embeds, use_kernel: bool):
    """The encoder memory of an encoder-decoder, None for the others (which
    ignore ``enc_embeds``, as the reference does)."""
    if not cfg.is_encdec:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name!r} is an encoder-decoder: it needs "
                         f"enc_embeds (B, F, d_model)")
    return run_encoder(params, cfg, enc_embeds, use_kernel=use_kernel)


def _train_stack(params, cfg: ModelConfig, x: torch.Tensor, use_kernel: bool,
                 memory):
    """Train mode: the full cycles of ``cfg.block_pattern``, then the
    remainder, as the reference scans them.  With ``cfg.remat`` and grad
    enabled, each full cycle runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint(cycle_fn)``): only the cycle's input is
    saved, and backward recomputes the cycle; values are unchanged."""
    pattern = cfg.block_pattern
    n_cycles = cfg.n_layers // len(pattern)
    layers = params["layers"]

    def run(x, aux, first: int, kinds):
        for j, kind in enumerate(kinds):
            x, _, a = block_apply(layers[first + j], cfg, kind, x,
                                  memory=memory, use_kernel=use_kernel)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0       # summed block by block, in layer order
    for c in range(n_cycles):
        first = c * len(pattern)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                run, x, aux, first, pattern, use_reentrant=False)
        else:
            x, aux = run(x, aux, first, pattern)
    first = n_cycles * len(pattern)
    x, aux = run(x, aux, first, cfg.layer_kinds()[first:])
    return x, [None] * cfg.n_layers, aux


def _stack_apply(params, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: bool = True, *, mode: str = "train", cache=None,
                 pos=None, memory=None):
    """Every layer in order: (x, the new cache entries, all None in train
    mode, the sum of the blocks' aux).  Train mode runs ``_train_stack``."""
    kinds = cfg.layer_kinds()
    if len(params["layers"]) != len(kinds):
        raise ValueError(
            f"params hold {len(params['layers'])} layers, cfg "
            f"{cfg.name!r} has {len(kinds)}")
    if mode == "train":
        return _train_stack(params, cfg, x, use_kernel, memory)
    entries = cache["layers"]
    new_entries, aux_total = [], 0.0
    for layer, kind, entry in zip(params["layers"], kinds, entries):
        x, ne, aux = block_apply(layer, cfg, kind, x, mode=mode, entry=entry,
                                 pos=pos, memory=memory,
                                 use_kernel=use_kernel)
        new_entries.append(ne)
        aux_total = aux_total + aux
    return x, new_entries, aux_total


def forward_features(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                     prefix_embeds=None, enc_embeds=None,
                     use_kernel: bool = True):
    """Train-mode forward up to the final norm: ((B, P + S, d) hidden, aux,
    the summed MoE load-balance loss, 0.0 without MoE blocks).
    ``prefix_embeds`` (B, P, d) go before the tokens; an encoder-decoder
    needs ``enc_embeds`` (B, F, d).  ``use_kernel=False`` runs the kernels'
    plain versions on any device."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    memory = _memory(params, cfg, enc_embeds, use_kernel)
    x, _, aux = _stack_apply(params, cfg, x, use_kernel, memory=memory)
    return _norm(cfg, params["final_norm"], x), aux


def head_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The (soft-capped) unembedding of final-norm hidden states: fp32
    logits."""
    head = params.get("lm_head", params["embed"])
    return softcap(unembed(head, x), cfg.logits_softcap)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, enc_embeds=None, use_kernel: bool = True):
    """Train-mode forward.  Returns (logits fp32 (B, P + S, vocab), aux)."""
    x, aux = forward_features(params, cfg, tokens,
                              prefix_embeds=prefix_embeds,
                              enc_embeds=enc_embeds, use_kernel=use_kernel)
    return head_logits(params, cfg, x), aux


@torch.no_grad()
def encode(params, cfg: ModelConfig, tokens: torch.Tensor, *,
           prefix_embeds=None, enc_embeds=None,
           use_kernel: bool = True) -> torch.Tensor:
    """Backbone features: final-norm hidden states (B, P + S, d), no
    unembed.

    The feature map h(X) of the paper's technique at scale: the frozen
    backbone is the ELM's random hidden layer, and the multi-task head
    learns (U, A_t) on top of these features.  Inference only;
    ``use_kernel=False`` runs the kernels' plain versions on any device."""
    return forward_features(params, cfg, tokens, prefix_embeds=prefix_embeds,
                            enc_embeds=enc_embeds, use_kernel=use_kernel)[0]


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then ``head_logits``."""
    return head_logits(params, cfg, _norm(cfg, params["final_norm"], x))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int, *,
            prefix_embeds=None, enc_embeds=None, cache_dtype=torch.bfloat16,
            use_kernel: bool = True):
    """Process the prompts: ``prefix_embeds`` (B, P, d) if given, then
    ``tokens`` (B, S), P + S <= max_len.  Returns (the last position's
    logits (B, 1, vocab) fp32, the cache at pos = P + S).

    The cache (``models.cache.init_cache``) lives on the tokens' device: KV
    lines of ``max_len`` slots and rings of ``min(sliding_window,
    max_len)`` in ``cache_dtype`` (bf16 by default, as in the reference,
    also for fp32 compute; int8 lines with ``cfg.kv_quant``), recurrent
    states in fp32; an encoder-decoder's ``ck`` and ``cv`` hold the cross
    k and v of the memory of ``enc_embeds`` (B, F, d), F slots.  Every
    ``swa`` block runs the ``swa`` kernel, every ``rglru`` block the
    ``rglru`` kernel and every mLSTM block the ``mlstm`` kernel on the card
    (``use_kernel=False``: their plain versions)."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, max_len, cache_dtype, device=tokens.device)
    memory = _memory(params, cfg, enc_embeds, use_kernel)
    x, layers, _ = _stack_apply(params, cfg, x, use_kernel, mode="prefill",
                                cache=cache, memory=memory)
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
    attention against the cache (an encoder-decoder's cross-attention over
    ``ck`` and ``cv`` too), the MoE FFN and the mLSTM and sLSTM steps are
    plain torch."""
    pos = cache["pos"]
    x, layers, _ = _stack_apply(params, cfg,
                                _embed_tokens(params, cfg, tokens),
                                use_kernel, mode="decode", cache=cache,
                                pos=pos)
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
