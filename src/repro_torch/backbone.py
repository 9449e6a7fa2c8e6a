"""Decentralized multi-task learning over a frozen transformer backbone with
a 2048-wide ELM hidden layer: the paper's technique at backbone scale, on
the fused stats pipeline.  The port of
``examples/decentralized_mtl_backbone.py``.

Pipeline:
  1. a backbone with random, frozen weights (the ELM philosophy: untrained
     features, analytic heads);
  2. 4 agents, each with a private classification task over its own token
     streams; data never leaves the agent;
  3. each batch goes through the backbone to mean-pooled d_model features
     (``pooled_features``), then into per-agent Gram statistics with the
     FUSED producer: the hidden layer ``H = sigmoid(X W + b)`` (d_model ->
     L = 2048) is computed inside the Gram kernel, so the (N, 2048) hidden
     features never reach device memory;
  4. (U_t, A_t) fitted by DMTL-ELM ring consensus with ``u_solver="pcg"``;
  5. held-out accuracy against Local-ELM heads (no sharing).

``main`` runs the example's own backbone-12m config with its constants.
The steps are functions of their own so that other scripts can run them on
another backbone (``chip_smoke.py`` runs recurrentgemma-2b through them).

Run:  PYTHONPATH=src python -m repro_torch.backbone [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core.dmtl_elm import DMTLELMConfig
from repro_torch.core.elm import make_feature_map
from repro_torch.core.graph import ring
from repro_torch.core.heads import fit_head_local, pooled_features
from repro_torch.data.pipeline import stream_sufficient_stats
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_model, param_count

N_AGENTS = 4
N_CLASSES = 4
L_HIDDEN = 2048         # ELM hidden width: the paper's L at backbone scale
BATCH, SEQ = 64, 64
N_BATCHES = 4           # feature-accumulation rounds per agent
ADMM_ITERS = 8          # each iteration runs a full PCG solve per agent
EVAL_BATCH = 64


def backbone_config() -> ModelConfig:
    return ModelConfig(
        name="backbone-12m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=32000,
        qk_norm=True, dtype="float32",
    )


def make_task_batch(gen: torch.Generator, task_id: int, n: int = BATCH,
                    seq: int = SEQ):
    """Each task: classify which of its private token-distribution modes
    generated the sequence.  A label draws tokens from a band of 8 over a
    shared 64-token alphabet, centred at 16 * label plus a small
    task-specific shift, so the tasks share structure (a learnable shared
    subspace U).  Returns (tokens (n, seq) int64, one-hot labels (n, C))."""
    dev = gen.device
    labels = torch.randint(0, N_CLASSES, (n,), generator=gen, device=dev)
    center = 16 * labels + 3 * (task_id % 4)
    noise = torch.randint(0, 8, (n, seq), generator=gen, device=dev)
    tokens = (center[:, None] + noise) % 64
    return tokens, F.one_hot(labels, N_CLASSES).float()


def token_batches(gen: torch.Generator, n_batches: int = N_BATCHES,
                  n: int = BATCH, seq: int = SEQ, m: int = N_AGENTS):
    """Yield (tokens (m, n, seq), labels (m, n, C)): one batch per agent."""
    for _ in range(n_batches):
        toks, labs = zip(*(make_task_batch(gen, t, n, seq) for t in range(m)))
        yield torch.stack(toks), torch.stack(labs)


def agent_batches(params, cfg: ModelConfig, batches):
    """(tokens, labels) batches -> (pooled backbone features (m, B, d_model),
    labels): the RAW-feature stream the fused producer consumes; no (N, L)
    hidden activations are formed here."""
    for tokens, labels in batches:
        yield pooled_features(params, cfg, tokens), labels


def admm_config(r: int = 8, iters: int = ADMM_ITERS) -> DMTLELMConfig:
    return DMTLELMConfig(r=r, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0,
                         iters=iters, u_solver="pcg", stats_producer="fused")


def fit(stats, cfg_admm: DMTLELMConfig):
    """DMTL-ELM on a ring of the stats' agents: (state, diagnostics)."""
    return engine.fit_dense(stats, ring(stats.G.shape[0]), cfg_admm)


def evaluate(params, cfg: ModelConfig, fmap, state, stats,
             cfg_admm: DMTLELMConfig, tokens, labels) -> dict:
    """Held-out accuracy of the DMTL heads and of Local-ELM heads (per-agent
    ridge on its own statistics).  Evaluation features are materialized
    (evaluation is small); the training-side H never was."""
    H = fmap(pooled_features(params, cfg, tokens))           # (m, B, L)
    truth = labels.argmax(-1)
    pred = torch.einsum("mbl,mlr,mrd->mbd", H, state.U, state.A)
    local = fit_head_local(stats, cfg_admm).predict_all(H)
    return {"dmtl": float((pred.argmax(-1) == truth).float().mean()),
            "local": float((local.argmax(-1) == truth).float().mean())}


def main(device: str = "cuda", seed: int = 0) -> dict:
    cfg = backbone_config()
    params = init_model(torch.Generator(device=device).manual_seed(seed), cfg)
    print(f"backbone params: {param_count(params) / 1e6:.1f}M (frozen)")

    fmap = make_feature_map(7, cfg.d_model, L_HIDDEN, dist="normal",
                            device=device)
    print(f"ELM hidden layer: {cfg.d_model} -> L={fmap.L} (fused into the "
          f"Gram kernel; H never materializes)")

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    t0 = time.perf_counter()
    stats = stream_sufficient_stats(
        agent_batches(params, cfg, token_batches(gen)),
        producer="fused", feature_map=fmap)
    print(f"streamed {int(stats.n[0])} samples/agent into (G, R) stats "
          f"[{time.perf_counter() - t0:.1f}s, G: {tuple(stats.G.shape)}]")

    cfg_admm = admm_config()
    t0 = time.perf_counter()
    state, diags = fit(stats, cfg_admm)
    print(f"DMTL-ELM fit (pcg, {ADMM_ITERS} iters) in "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"  objective: {float(diags['objective'][0]):.1f} -> "
          f"{float(diags['objective'][-1]):.1f}")
    print(f"  consensus residual: {float(diags['consensus'][0]):.3e} -> "
          f"{float(diags['consensus'][-1]):.3e}")

    tokens, labels = next(token_batches(
        torch.Generator(device=device).manual_seed(seed + 99), 1,
        n=EVAL_BATCH))
    acc = evaluate(params, cfg, fmap, state, stats, cfg_admm, tokens, labels)
    print(f"Local-ELM heads accuracy: {acc['local']:.3f}")
    print(f"DMTL-ELM  heads accuracy: {acc['dmtl']:.3f}")
    print("fused-stats decentralized heads fitted at L=2048 ✓")
    return {"accuracy": acc, "objective": diags["objective"],
            "consensus": diags["consensus"], "n": int(stats.n[0])}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(device=args.device, seed=args.seed)
