"""Analytic FLOP model per (arch, shape): the reference's
``analysis/flops.py``, pure arithmetic on ``ModelConfig``, copied so that
the port computes the same numbers without importing it.

Conventions: matmul (m,k)x(k,n) = 2mkn FLOPs; training = 3x forward
(fwd + 2x bwd); causal attention halves the score work; decode touches all
weights once per token (memory: weight bytes dominate).
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _attn_flops_fwd(cfg, B, S_q, S_kv, causal=True):
    hd = cfg.head_dim
    H = cfg.n_heads
    kv = cfg.n_kv_heads
    frac = 0.5 if (causal and S_q == S_kv) else 1.0
    qk_av = 2 * 2 * B * S_q * S_kv * H * hd * frac
    proj = 2 * B * S_q * cfg.d_model * hd * (H + 2 * kv) + \
        2 * B * S_q * H * hd * cfg.d_model
    return qk_av + proj


def _mlp_flops_fwd(cfg, B, S, d_ff):
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return 2 * B * S * cfg.d_model * d_ff * n_mats


def _moe_flops_fwd(cfg, B, S):
    per_tok = 2 * cfg.d_model * cfg.moe_d_ff * 3 * cfg.n_experts_active
    router = 2 * cfg.d_model * cfg.n_experts
    return B * S * (per_tok + router)


def _mlstm_flops_fwd(cfg, B, S):
    d = cfg.d_model
    dm = int(cfg.mlstm_proj_factor * d)
    D = dm // cfg.n_heads
    c = min(cfg.chunk_size, S)
    proj = 2 * B * S * d * (2 * dm) + 2 * B * S * dm * dm * 3 + 2 * B * S * dm * d
    intra = 2 * 2 * B * S * c * dm * 0.5          # qk^T and S@v per chunk
    state = 2 * 2 * B * S * dm * D                # kv outer + C@q
    return proj + intra + state


def _slstm_flops_fwd(cfg, B, S):
    d = cfg.d_model
    D = d // cfg.n_heads
    df = int(cfg.slstm_proj_factor * d)
    return (2 * B * S * d * 4 * d             # w_x
            + 2 * B * S * d * 4 * D           # recurrent block-diag
            + 2 * B * S * d * 2 * df + 2 * B * S * df * d)


def _rglru_flops_fwd(cfg, B, S):
    d, dr = cfg.d_model, cfg.d_rnn
    return (2 * B * S * d * dr * 2 + 2 * B * S * dr * d
            + 2 * B * S * dr * dr * 2          # r/i gates
            + B * S * dr * (2 * cfg.conv1d_width + 10))


def _block_flops_fwd(cfg, kind, B, S_q, S_kv, causal=True):
    if kind in ("attn", "swa"):
        S_eff = min(S_kv, cfg.sliding_window) if kind == "swa" else S_kv
        return _attn_flops_fwd(cfg, B, S_q, S_eff, causal) + \
            _mlp_flops_fwd(cfg, B, S_q, cfg.d_ff)
    if kind == "moe":
        S_eff = S_kv
        return _attn_flops_fwd(cfg, B, S_q, S_eff, causal) + \
            _moe_flops_fwd(cfg, B, S_q)
    if kind == "mlstm":
        return _mlstm_flops_fwd(cfg, B, S_q)
    if kind == "slstm":
        return _slstm_flops_fwd(cfg, B, S_q)
    if kind == "rglru":
        return _rglru_flops_fwd(cfg, B, S_q) + \
            _mlp_flops_fwd(cfg, B, S_q, cfg.d_ff)
    raise ValueError(kind)


def _embed_head_flops_fwd(cfg, B, S):
    return 2 * B * S * cfg.d_model * cfg.vocab_size  # unembed matmul


def analytic_cost(cfg: ModelConfig, shape) -> dict:
    """{"flops": the global FLOPs of one step of ``shape``}."""
    B, S = shape.batch, shape.seq
    if shape.kind in ("train", "prefill"):
        S_q = S_kv = S
        fwd = _embed_head_flops_fwd(cfg, B, S_q if shape.kind == "train" else B)
        if shape.kind == "prefill":
            fwd = _embed_head_flops_fwd(cfg, B, 1)  # only last-token logits
        for kind in cfg.layer_kinds():
            fwd += _block_flops_fwd(cfg, kind, B, S_q, S_kv)
        if cfg.is_encdec:
            F = cfg.enc_seq
            for _ in range(cfg.n_enc_layers):
                fwd += _attn_flops_fwd(cfg, B, F, F, causal=False) + \
                    _mlp_flops_fwd(cfg, B, F, cfg.d_ff)
            # cross attention per decoder layer
            fwd += cfg.n_layers * (
                _attn_flops_fwd(cfg, B, S_q, F, causal=False)
                - _mlp_flops_fwd(cfg, B, 0, cfg.d_ff))
        total = 3 * fwd if shape.kind == "train" else fwd
        return {"flops": float(total)}

    # decode: one token against an S-long cache
    fwd = _embed_head_flops_fwd(cfg, B, 1)
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            S_eff = S
        elif kind == "swa":
            S_eff = min(S, cfg.sliding_window)
        else:
            S_eff = 1
        fwd += _block_flops_fwd(cfg, kind, B, 1, S_eff, causal=False)
    if cfg.is_encdec:
        fwd += cfg.n_layers * _attn_flops_fwd(cfg, B, 1, cfg.enc_seq,
                                              causal=False)
    return {"flops": float(fwd)}
