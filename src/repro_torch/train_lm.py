"""LM pretraining example: a small decoder (3 layers, d 256, qwen3-like)
trained for a few hundred steps on the deterministic synthetic pipeline,
then checkpointed, reloaded and checked to give the same loss.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--steps 200] \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.transformer import init_model, param_count
from repro_torch.optim import AdamWConfig, adamw_init, cosine_warmup
from repro_torch.training.steps import loss_fn, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_smoke_config("qwen3-8b"), name="lm-example", n_layers=3,
        d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
    )
    params = init_model(0, cfg, device=args.device)
    print(f"params: {param_count(params)/1e6:.2f}M")

    opt_cfg = AdamWConfig(lr=cosine_warmup(3e-3, 20, args.steps))
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)

    losses = []
    for step in range(args.steps):
        batch = make_batch(data, step, args.device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0] - 0.5:
        raise RuntimeError("training failed to improve")

    tmp = tempfile.mkdtemp()
    try:
        save_checkpoint(tmp, args.steps, params, {"arch": cfg.name})
        restored, _ = load_checkpoint(tmp, params)
        batch = make_batch(data, args.steps + 1, args.device)
        with torch.no_grad():
            l1 = float(loss_fn(params, cfg, batch)[0])
            l2 = float(loss_fn(restored, cfg, batch)[0])
        if abs(l1 - l2) >= 1e-5:
            raise RuntimeError(f"restored loss {l2} != {l1}")
        print(f"checkpoint round-trip verified (loss {l2:.4f})")
    finally:
        shutil.rmtree(tmp)
    return {"losses": losses, "restored_loss": l2}


if __name__ == "__main__":
    main()
