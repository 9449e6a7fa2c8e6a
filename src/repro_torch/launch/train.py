"""End-to-end training driver: real AdamW steps of a model of the registry
on the synthetic pipeline, with log rows and checkpoints.

The model runs on the card unless ``--device cpu`` (with ``--smoke``, the
reduced config, for a CPU run).  Training takes the train variant of the
config (``launch.shapes.variant_for_shape``: remat on), which changes
memory and no value.  The forward runs the kernels' plain versions
(``training.steps``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 20 --batch 8 --seq 128 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.shapes import InputShape, variant_for_shape
from repro_torch.models.transformer import init_model, param_count
from repro_torch.optim import AdamWConfig, adamw_init, cosine_warmup
from repro_torch.training.steps import make_train_step


def build(arch: str, smoke: bool, seq: int, overrides: dict):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = build(args.arch, args.smoke, args.seq, {})
    cfg = variant_for_shape(cfg, InputShape("cli", "train", args.seq,
                                            args.batch))
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model}")

    device = args.device
    params = init_model(args.seed, cfg, device=device)
    print(f"[train] params: {param_count(params)/1e6:.2f}M")
    opt_cfg = AdamWConfig(
        lr=cosine_warmup(args.lr, args.warmup, args.steps), clip_norm=1.0)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    frontends = {}
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(7)
        frontends["prefix_embeds"] = 0.1 * torch.randn(
            (args.batch, cfg.n_prefix_embeddings, cfg.d_model),
            generator=gen, device=device)
    if cfg.family == "audio":
        gen = torch.Generator(device=device).manual_seed(8)
        frontends["enc_embeds"] = 0.1 * torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=device)

    log = []
    _sync(device)
    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch(data_cfg, step, device)
        batch.update(frontends)
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            _sync(device)
            row = {
                "step": step,
                "loss": float(metrics["loss"]),
                "ce": float(metrics["ce"]),
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(metrics["lr"]),
                "step_seconds": time.perf_counter() - t_step,
                "seconds": round(time.time() - t0, 1),
            }
            log.append(row)
            print(f"[train] {row}")
        if args.ckpt_every and args.ckpt_dir and \
                (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, params,
                            {"arch": cfg.name})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, params, {"arch": cfg.name})
    if args.log_file:
        Path(args.log_file).write_text(json.dumps(log, indent=2))
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return log


if __name__ == "__main__":
    main()
