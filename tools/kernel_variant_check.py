#!/usr/bin/env python3
"""Time and check one copy of the port's `mlstm` or `rglru` kernel, on one CUDA
card: the source tree given (default ``src``), so that a variant of a kernel's
``.cu``, written into a copy of ``src/`` outside the repository, can be held
against the same checks as the repository's own.

  python3 tools/kernel_variant_check.py mlstm [SRC]
      bf16 ``mlstm`` at phase 8's call (8, 4, 4096, 1024, chunk 256): CUDA-event
      times (``chip_smoke.time_ms``), the device time of each grid
      (``chip_smoke.device_split``), ||h - plain|| / ||plain|| there and in the
      long-memory case (1, 4, 4096, 1024); then phase 8's checks on agent 0's
      first batch of xlstm-1.3b: every mLSTM block against its plain version
      on the same input (``chip_smoke.block_errors``) and the pooled features
      end to end against the plain path (of max |plain| and in norm).
  python3 tools/kernel_variant_check.py rglru [SRC]
      ``rglru`` at phase 6's call (8, 4096, 2560), a ragged (3, 1000, 300)
      and a (2, 40, 66) case: times and max |h - plain| / max |plain|.

Prints one JSON line "VARIANT {...}".  Run from the repository root.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    kind = sys.argv[1]
    src = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "src")
    sys.path.insert(0, src)
    sys.path.insert(1, os.getcwd())
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"kernel": kind, "src": src, "nvidia_smi": cs.nvidia_smi()}
    if kind == "rglru":
        from repro_torch.kernels.rglru import kernel
        from repro_torch.kernels.rglru.ref import rglru_scan_ref
        assert kernel.__file__.startswith(src), kernel.__file__
        _build.build(kernel.SOURCE)
        for label, (B, S, D) in (("main_path", (8, 4096, 2560)),
                                 ("ragged", (3, 1000, 300)), ("odd", (2, 40, 66))):
            log_a = -torch.nn.functional.softplus(
                torch.randn(B, S, D, device="cuda", generator=gen))
            b = torch.randn(B, S, D, device="cuda", generator=gen)
            h0 = torch.randn(B, D, device="cuda", generator=gen)
            h = kernel.rglru(log_a, b, h0)
            out[label] = {"rel": cs.rel_err(torch, h, rglru_scan_ref(log_a, b, h0))[1],
                          "ms": [cs.time_ms(torch, lambda: kernel.rglru(log_a, b, h0))
                                 for _ in range(3)]}
        print("VARIANT", json.dumps(out), flush=True)
        return 0

    from repro_torch import backbone, configs
    from repro_torch.core.heads import pooled_features
    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.models import transformer
    assert kernel.__file__.startswith(src), kernel.__file__
    _build.build(kernel.SOURCE)
    out["ptxas"] = cs.ptxas_resources(
        _build.library_path(kernel.SOURCE).with_suffix(".log").read_text())

    def inputs(B, H, S, D, long):
        q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        f = (torch.full((B, H, S), -0.01, device="cuda") if long else
             torch.nn.functional.logsigmoid(
                 torch.randn(B, H, S, device="cuda", generator=gen) + 2.0))
        i = torch.randn(B, H, S, device="cuda", generator=gen)
        return q, k, v, f, i

    x = inputs(8, 4, 4096, 1024, False)
    out["ms"] = [cs.time_ms(torch, lambda: kernel.mlstm(*x, 256)) for _ in range(2)]
    out["device_ms"] = cs.device_split(torch, lambda: kernel.mlstm(*x, 256), calls=3)
    for label, y in (("main_norm", x), ("long_norm", inputs(1, 4, 4096, 1024, True))):
        out[label] = cs.norm_rel(torch, kernel.mlstm(*y, 256), mlstm_chunkwise_ref(*y, 256))
    del x, y
    torch.cuda.empty_cache()
    xl = configs.get_config("xlstm-1.3b")
    params = transformer.init_model(torch.Generator(device="cuda").manual_seed(0), xl)
    tok0 = next(backbone.token_batches(torch.Generator(device="cuda").manual_seed(1), 1,
                                       n=8, seq=4096, m=4))[0][:1]
    with torch.no_grad():
        out["blocks"] = cs.block_errors(torch, params, xl, tok0[0])
        f_k = pooled_features(params, xl, tok0)
        f_p = pooled_features(params, xl, tok0, use_kernel=False)
    out["pooled_rel"] = cs.rel_err(torch, f_k, f_p)[1]
    out["pooled_norm"] = cs.norm_rel(torch, f_k, f_p)
    print("VARIANT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
