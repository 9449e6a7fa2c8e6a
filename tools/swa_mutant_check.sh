#!/bin/bash
# Mutation check of the swa gates in chip_smoke.py, on one CUDA card.
#
# Copies src/ into WORKDIR (default: a fresh temporary directory), breaks
# the copy's bf16 swa kernel so that it skips the boundary kv tile of every
# full window (kv_begin + 1 when q0 >= window), builds it, and prints one
# JSON line "MUTANT {...}": the broken kernel against its plain version at
# phase 6's call and at recurrentgemma-2b's S = 8192 shape (both bf16), as
# max |o - plain| / max |plain| and ||o - plain|| / ||plain|| beside
# SWA_NORM_TOL, and phase 6's check (c) (bf16 pooled features, kernels
# against plain versions) with the broken kernel.  The repository itself is
# not touched.
#
# Run from the repository root:  bash tools/swa_mutant_check.sh [WORKDIR]
set -euo pipefail
MUT=${1:-$(mktemp -d)}
mkdir -p "$MUT"
rm -rf "$MUT/src"
cp -r src "$MUT/src"
rm -rf "$MUT/src/repro_torch/kernels/_build"
CU="$MUT/src/repro_torch/kernels/swa/csrc/swa.cu"
sed -i 's|const int kv_begin = max(0, q0 - window + 1) / BKV;|const int kv_begin = max(0, q0 - window + 1) / BKV + (q0 >= window ? 1 : 0);|' "$CU"
grep -q "BKV + (q0 >= window ? 1 : 0)" "$CU"
MUT_SRC="$MUT/src" python3 - <<'PY'
import json
import os
import sys

sys.path.insert(0, os.environ["MUT_SRC"])
sys.path.insert(1, ".")
import torch

import chip_smoke
from repro_torch import backbone, configs
from repro_torch.core.heads import pooled_features
from repro_torch.kernels.swa import kernel
from repro_torch.kernels.swa.ref import swa_ref
from repro_torch.models import transformer

assert kernel.__file__.startswith(os.environ["MUT_SRC"]), kernel.__file__
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
tol = chip_smoke.SWA_NORM_TOL["bf16"]
out = {"norm_tol": tol}
for label, (B, H, KV, S, D, W) in (
        ("main_path_bf16", (8, 10, 1, 4096, 256, 2048)),
        ("recurrentgemma_s8192_bf16", (1, 10, 1, 8192, 256, 2048))):
    q = torch.randn(B, H, S, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, KV, S, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, KV, S, D, device="cuda", generator=gen).bfloat16()
    o, p = kernel.swa(q, k, v, W), swa_ref(q, k, v, W)
    norm = chip_smoke.norm_rel(torch, o, p)
    out[label] = {"rel_max": chip_smoke.rel_err(torch, o.float(),
                                                p.float())[1],
                  "norm_rel": norm, "norm_rel_over_tol": norm / tol}
    del q, k, v, o, p
    torch.cuda.empty_cache()
# phase 6's check (c): agent 0's first batch, same seeds as chip_smoke.py
rg = configs.get_config("recurrentgemma-2b")
params = transformer.init_model(
    torch.Generator(device="cuda").manual_seed(0), rg)
tokens = next(backbone.token_batches(
    torch.Generator(device="cuda").manual_seed(1), 1, n=8, seq=4096,
    m=4))[0][:1]
f_k = pooled_features(params, rg, tokens)
f_p = pooled_features(params, rg, tokens, use_kernel=False)
out["check_c"] = {"rel_max": chip_smoke.rel_err(torch, f_k, f_p)[1],
                  "norm_rel": chip_smoke.norm_rel(torch, f_k, f_p)}
print("MUTANT", json.dumps(out))
PY
