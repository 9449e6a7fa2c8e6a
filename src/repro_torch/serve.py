"""Serving example: batched prefill and decode with KV, ring and recurrent
caches across three architecture families, then the continuous-batching
engine serving more requests than it has slots.  The port of
``examples/serve_batched.py``.

On the card every ``swa`` block of a prefill runs the ``swa`` kernel, every
``rglru`` block the ``rglru`` kernel (in prefill and in each decode step)
and every mLSTM block's prefill the ``mlstm`` kernel; the attention against
the caches is plain torch.  Weights are random, drawn from a seed.

Run:  PYTHONPATH=src python -m repro_torch.serve [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request
from repro_torch.serving.steps import generate

ARCHS = ("qwen3-8b", "recurrentgemma-2b", "xlstm-1.3b")


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device: str = "cuda", seed: int = 0) -> dict:
    """Generate 16 tokens for 4 prompts of 32 on each family's smoke
    config, then 8 ragged requests through 3 engine slots (qwen3-8b).
    Returns what it printed, as numbers."""
    out = {"generate": {}}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = init_model(seed, cfg, device=device)
        B, S, NEW = 4, 32, 16
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device)
        t0 = time.perf_counter()
        tokens, cache = generate(params, cfg, prompt, max_new=NEW,
                                 max_len=S + NEW)
        _sync(device)
        dt = time.perf_counter() - t0
        assert tokens.shape == (B, NEW)
        assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        pos = int(cache["pos"][0])
        print(f"{arch:22s} generated {NEW} tokens x {B} seqs "
              f"in {dt:.2f}s (cache pos {pos})", flush=True)
        out["generate"][arch] = {"seconds": dt, "pos": pos}
    print("batched serving across dense / hybrid / ssm families ✓",
          flush=True)

    # continuous batching: 8 ragged requests through 3 slots
    cfg = get_smoke_config("qwen3-8b")
    params = init_model(seed, cfg, device=device)
    eng = ContinuousBatchingEngine(params, cfg, batch_slots=3, max_len=64,
                                   device=device)
    for rid in range(8):
        plen = 6 + 3 * (rid % 4)
        gen = torch.Generator(device=device).manual_seed(seed + 100 + rid)
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=gen,
                               device=device)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4 + rid % 3))
    t0 = time.perf_counter()
    stats = eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"continuous batching: {stats.completed} requests "
          f"({stats.decoded_tokens} tokens) in {stats.steps} engine steps, "
          f"{dt:.2f}s ✓", flush=True)
    assert stats.completed == 8
    out["engine"] = {"completed": stats.completed, "steps": stats.steps,
                     "decoded_tokens": stats.decoded_tokens, "seconds": dt}
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(device=args.device, seed=args.seed)
