#!/usr/bin/env python3
"""Calibrate the limits of ``chip_smoke.py``'s phase 8b on one CUDA card,
on recurrentgemma-2b at full width and depth, by running the port as it is
and broken copies of it, made in memory in this process (the files are not
touched).

``--part fp32`` reads ``SERVE_FP32_TOL``: phase 8b (a) (fp32, 2 prompts of
2100 tokens, 16 greedy decode steps, each step's logits against the last
position of a train-mode forward), sound and with

  ring_slot_off_by_one  a sliding-window decode step writes its k and v at
                        slot (pos + 1) % W instead of pos % W;
  conv_state_dropped    an RG-LRU block from a carried state starts its
                        causal conv from zeros instead of the carried inputs.

``--part bf16`` reads ``SERVE_BF16_NORM_TOL``, ``SERVE_INT8_NORM_TOL`` and
``INT8_ROW_TOL``: phase 8b (b) (bf16, 4 prompts of 2560 tokens, 32 steps:
the kernels against their plain versions and an int8 KV cache against the
bf16 one, in norm, and the int8 rows read back against the bf16 rows), sound
and with

  swa_window_off_by_one  the ``swa`` kernel is called with window W - 1
                         (its plain version keeps W);
  rglru_h0_dropped       the ``rglru`` kernel is called from a zero state
                         (its plain version keeps the carried h);
  int8_trunc             int8 quantization truncates instead of rounding
                         half to even;
  int8_scale_ulp         int8 reads take each row's bf16 scale one ulp up;
  int8_scale_next_slot   a prefill writes each int8 row's scale one slot
                         further on;

and a control for the noise floor, ``kv_rounded_again``: greedy decoding on
the bf16 path against the same path, on the same tokens, with every k and v
it writes into its cache multiplied by (1 + r 2^-8), r uniform in [-1, 1],
and rounded to bf16 again, which moves a share of them by one bf16 ulp.

Prints one line "MUTANT {...}" per run, with the card's name and power
limit.  Each limit must sit above the sound readings and the control, and
below the broken ones it is meant to catch; ``INT8_ROW_TOL`` is a bound, and
the readings show which mutants it catches.

  python3 tools/serving_mutant_check.py [--part fp32|bf16|all]
                                        (from the repository root)
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import sys


def _mutate(module, name: str, old: str, new: str) -> None:
    """Redefine ``module.name`` from its source with ``old`` replaced."""
    src = inspect.getsource(getattr(module, name))
    if old not in src:
        raise RuntimeError(f"{name}: {old!r} not in its source")
    exec(compile(src.replace(old, new), module.__file__, "exec"),
         module.__dict__)


class _Mutants:
    """Applies one in-memory mutation at a time and undoes it."""

    def __init__(self):
        self.saved = []

    def mutate(self, module, name, old, new, also=()):
        """``also``: modules that imported ``name`` from ``module``."""
        self.saved.append((module, name, getattr(module, name)))
        self.saved += [(m, name, getattr(m, name)) for m in also]
        _mutate(module, name, old, new)
        for m in also:
            setattr(m, name, getattr(module, name))

    def undo(self):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("fp32", "bf16", "all"), default="all")
    part = ap.parse_args().part
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    sys.path.insert(1, os.getcwd())
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import kernel as mlstm_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.models import attention, kvquant, rglru, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = {"swa": swa_kernel, "rglru": rglru_kernel,
                "mlstm": mlstm_kernel}
    for w in wrappers.values():
        _build.build(w.SOURCE)
    smi = cs.nvidia_smi()
    rg = configs.get_config("recurrentgemma-2b")
    params = transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), rg)
    # the prompts of phase 8b (a) and (b), drawn as chip_smoke draws them
    gen = torch.Generator(device="cuda").manual_seed(24)
    prompt_a = torch.randint(0, rg.vocab_size, (2, 2100), device="cuda",
                             generator=gen)
    prompt_b = torch.randint(0, rg.vocab_size, (4, 2560), device="cuda",
                             generator=gen)
    mut = _Mutants()

    def emit(label, **rec):
        print("MUTANT", json.dumps({"mutant": label, **rec,
                                    "nvidia_smi": smi}), flush=True)

    if part in ("fp32", "all"):
        cfg = dataclasses.replace(rg, dtype="float32")
        prompt = prompt_a

        def reading(label):
            rec = cs.serve_vs_forward(torch, params, cfg, wrappers, prompt,
                                      16)
            emit(label, part="fp32", max_rel=rec["max_rel"],
                 logits_vs_forward_rel=rec["logits_vs_forward_rel"],
                 tol=cs.SERVE_FP32_TOL)

        reading("none")
        mut.mutate(transformer, "_decode_attention_block",
                   "slot = (pos % S).long()", "slot = ((pos + 1) % S).long()")
        reading("ring_slot_off_by_one")
        mut.undo()
        mut.mutate(rglru, "rglru_block",
                   "None if state is None else state.conv", "None",
                   also=(transformer,))
        reading("conv_state_dropped")
        mut.undo()

    if part in ("bf16", "all"):
        prompt = prompt_b
        steps, max_len = 32, 2560 + 32
        tol = {"plain_norm": cs.SERVE_BF16_NORM_TOL,
               "int8_norm": cs.SERVE_INT8_NORM_TOL,
               "int8_row": cs.INT8_ROW_TOL}

        def reading(label):
            rec = cs.serve_bf16(torch, params, rg, wrappers, prompt, steps)
            emit(label, part="bf16",
                 plain_max_norm_rel=rec["plain"]["max_norm_rel"],
                 int8_max_norm_rel=rec["int8_kv"]["max_norm_rel"],
                 int8_row_err=rec["int8_kv"]["row_err"],
                 plain_norm_rel=rec["plain"]["norm_rel"],
                 int8_norm_rel=rec["int8_kv"]["norm_rel"], tol=tol)
            torch.cuda.empty_cache()

        reading("none")
        mut.mutate(attention, "causal_attention",
                   "v.transpose(1, 2), window=window,",
                   "v.transpose(1, 2), window=window - int(use_kernel),")
        reading("swa_window_off_by_one")
        mut.undo()
        mut.mutate(rglru, "_rglru_scan",
                   "rglru_scan(log_a, b, h0, force_ref=not use_kernel)",
                   "rglru_scan(log_a, b, torch.zeros_like(h0) if use_kernel"
                   " else h0, force_ref=not use_kernel)")
        reading("rglru_h0_dropped")
        mut.undo()
        mut.mutate(kvquant, "quantize", "torch.round(xf / scale)",
                   "torch.trunc(xf / scale)", also=(transformer,))
        reading("int8_trunc")
        mut.undo()
        mut.mutate(kvquant, "dequantize", "qkv.scale.float()",
                   "_scale_ulp_up(qkv.scale).float()")
        kvquant._scale_ulp_up = lambda s: (s.view(torch.int16) + 1).view(
            torch.bfloat16)
        reading("int8_scale_ulp")
        mut.undo()
        mut.mutate(transformer, "_prefill_kv",
                   "line.scale[:, slots] = qt.scale",
                   "line.scale[:, (slots + 1) % W] = qt.scale")
        reading("int8_scale_next_slot")
        mut.undo()

        # the noise floor: the bf16 path against itself, k and v rounded
        # once more on their way into the cache
        tokens, base = cs.greedy_logits(torch, params, rg, prompt, steps,
                                        max_len)
        noise = torch.Generator(device="cuda").manual_seed(9)

        def round_again(x):
            r = torch.rand(x.shape, device=x.device, generator=noise)
            return (x.float() * (1 + (2 * r - 1) * 2.0 ** -8)).to(x.dtype)

        transformer._round_again = round_again
        mut.mutate(transformer, "_prefill_kv",
                   "line[:, slots] = t[:, p0].to(line.dtype)",
                   "line[:, slots] = _round_again(t[:, p0].to(line.dtype))")
        mut.mutate(transformer, "_decode_attention_block",
                   "new = new.to(line.dtype)",
                   "new = _round_again(new.to(line.dtype))")
        rows = cs.replay_logits(torch, params, rg, prompt, tokens,
                                max_len)[0]
        mut.undo()
        norms = [cs.norm_rel(torch, a, b) for a, b in zip(rows, base)]
        emit("kv_rounded_again", part="bf16", max_norm_rel=max(norms),
             norm_rel=norms, tol=tol)
    return 0


if __name__ == "__main__":
    sys.exit(main())
