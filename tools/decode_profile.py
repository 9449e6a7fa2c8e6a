#!/usr/bin/env python3
"""Split one fp32 decode step of granite-moe-3b-a800m (full width and
depth, B = 2, a 1024-token prompt, drop-free capacity) and of
seamless-m4t-large-v2 (12 + 12 layers, 1024 frames, 256 tokens) into host
wall time and device time on one CUDA card: 5 timed steps (host clock
around a synchronized step), then 3 steps under ``torch.profiler`` (device
time and launches a step, the top kernels by device and host time); and
granite's MoE FFN alone at S = 1, B = 2 (one layer, 20 calls).  Prints
"PROF {...}" lines, "MOE_FFN_S1_MS ..." and the card's name and power
limit.

  python3 tools/decode_profile.py        (from the repository root)
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def split(torch, label, params, cfg, prompt, **frontend) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer

    P = frontend["prefix_embeds"].shape[1] if "prefix_embeds" in frontend \
        else 0
    lg, cache = transformer.prefill(params, cfg, prompt,
                                    P + prompt.shape[1] + 40,
                                    cache_dtype=torch.float32, **frontend)
    nt = lg[:, -1].argmax(-1, keepdim=True)
    for _ in range(3):                                  # warm-up
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lg, cache = transformer.decode_step(params, cfg, nt, cache)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    by_device = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    by_host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:8]
    out = {
        "label": label, "wall_ms": walls,
        "device_ms_per_step":
            sum(e.self_device_time_total for e in ka) / 3 / 1e3,
        "device_launches_per_step":
            sum(e.count for e in ka if e.self_device_time_total > 0) / 3,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 3 / 1e3
                          for e in by_device},
        "top_cpu_ms": {e.key[:60]: e.self_cpu_time_total / 3 / 1e3
                       for e in by_host}}
    print("PROF " + json.dumps(out), flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    from repro_torch import configs
    from repro_torch.models import moe, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(25)

    def weights(cfg):
        return transformer.init_model(
            torch.Generator(device="cuda").manual_seed(0), cfg)

    gm = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                             dtype="float32")
    params = weights(gm)
    prompt = torch.randint(0, gm.vocab_size, (2, 1024), device="cuda",
                           generator=gen)
    split(torch, "granite_fp32", params, chip_smoke.drop_free(gm), prompt)
    x = torch.randn(2, 1, gm.d_model, device="cuda", generator=gen)
    layer = params["layers"][0]["moe"]
    for _ in range(3):
        moe.moe_ffn(layer, gm, x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        moe.moe_ffn(layer, gm, x)
    torch.cuda.synchronize()
    print("MOE_FFN_S1_MS", (time.perf_counter() - t) / 20 * 1e3, flush=True)
    del params, layer
    torch.cuda.empty_cache()

    sm = dataclasses.replace(configs.get_config("seamless-m4t-large-v2"),
                             dtype="float32")
    params = weights(sm)
    enc = torch.randn(2, sm.enc_seq, sm.d_model, device="cuda",
                      generator=gen) * sm.d_model ** -0.5
    prompt = torch.randint(0, sm.vocab_size, (2, 256), device="cuda",
                           generator=gen)
    split(torch, "seamless_fp32", params, sm, prompt, enc_embeds=enc)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
