#!/usr/bin/env python3
"""Where a training step's time goes, on one CUDA card: recurrentgemma-2b at
full width and depth (seeded fp32 weights, bf16 compute, the train variant:
remat on), phase 8d's batch of 2 x 2048 tokens, the step
``chip_smoke.py``'s phase 8d runs (``training.steps.train_step``: the
kernels' plain versions under autograd, then AdamW).

Prints one JSON line per reading:
  step          seconds of whole steps (loss, gradients, update), remat on
                and off, after one warm-up step each;
  parts         the parts timed alone, each in a loop of its own: the plain
                forward (no grad); one RG-LRU block's plain scan loop at the
                step's shape, forward and backward (a step runs 18 of them,
                each forward twice under remat); the chunked cross-entropy
                on the final hidden state, forward and backward; the AdamW
                update of every parameter;
  profile       ``torch.profiler`` (CUDA activity) over one step: the kernel
                launches, the summed device time of the kernels against the
                step's wall time (the device's busy share), and the kernels
                with the most device time.
and last the card's name and power limit.

  python3 tools/train_profile.py        (from the repository root)
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, BATCH, SEQ = "recurrentgemma-2b", 2, 2048


def timed(torch, fn, repeats: int = 1) -> list:
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def main() -> int:
    import torch

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.launch import shapes
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.training import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = shapes.variant_for_shape(configs.get_config(ARCH),
                                   shapes.SHAPES["train_4k"])
    params = transformer.init_model(0, cfg, device="cuda")
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-5)
    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH), 0,
        "cuda")

    def step(c):
        nonlocal params, opt
        params, opt, _ = steps.train_step(params, opt, batch, c, ocfg)

    rec = {"arch": ARCH, "batch": BATCH, "seq": SEQ}
    for name, c in (("remat", cfg),
                    ("no_remat", dataclasses.replace(cfg, remat=False))):
        torch.cuda.reset_peak_memory_stats()
        s = timed(torch, lambda: step(c), repeats=3)
        rec[f"{name}_s"] = s
        rec[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"reading": "step", **rec}), flush=True)

    parts = {}
    with torch.no_grad():
        parts["forward_plain_s"] = timed(torch, lambda: steps.loss_fn(
            params, cfg, batch), repeats=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    D = cfg.d_rnn
    log_a = (-torch.rand((BATCH, SEQ, D), generator=gen, device="cuda")
             * 0.1).requires_grad_()
    b = torch.randn((BATCH, SEQ, D), generator=gen,
                    device="cuda").requires_grad_()
    h0 = torch.zeros((BATCH, D), device="cuda")

    def scan_fwd_bwd():
        rglru_scan_ref(log_a, b, h0).sum().backward()

    def scan_fwd():
        with torch.no_grad():
            rglru_scan_ref(log_a, b, h0)

    parts["rglru_loop_fwd_s"] = timed(torch, scan_fwd, repeats=2)
    parts["rglru_loop_fwd_bwd_s"] = timed(torch, scan_fwd_bwd, repeats=2)
    n_rglru = cfg.layer_kinds().count("rglru")
    parts["rglru_blocks"] = n_rglru
    hidden = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16).requires_grad_()
    head = {"table": params["embed"]["table"].detach().requires_grad_()}

    def ce():
        tot, cnt = steps.chunked_cross_entropy(head, cfg, hidden,
                                               batch["labels"])
        (tot / cnt).backward()

    parts["ce_chunks_fwd_bwd_s"] = timed(torch, ce, repeats=2)
    del head, hidden
    _, _, grads = steps.loss_and_grads(params, cfg, batch)
    parts["adamw_s"] = timed(torch, lambda: adamw_update(
        grads, opt, params, ocfg), repeats=2)
    del grads
    print(json.dumps({"reading": "parts", **parts}), flush=True)

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "reading": "profile", "wall_s": wall, "launches": len(kernels),
        "device_busy_s": busy_us / 1e6, "busy_share": busy_us / 1e6 / wall,
        "top": [{"name": n[:80], "launches": c, "device_s": us / 1e6}
                for n, (c, us) in top]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
