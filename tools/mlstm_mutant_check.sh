#!/bin/bash
# Mutation check of the mlstm gates in chip_smoke.py, on one CUDA card.
#
# Copies src/ into WORKDIR (default: a fresh temporary directory), breaks
# the copy's mlstm kernel so that the carried state does not decay across
# chunk boundaries (decay_C forced to 1 in the states grid), builds it, and
# prints one JSON line "MUTANT {...}": the broken kernel against its plain
# version in phase 3's long-memory case (log_f = -0.01) and at phase 8's call
# (bf16), as max |h - plain| / max |plain| and ||h - plain|| / ||plain||
# beside MLSTM_NORM_TOL, and phase 8's check (c) with the broken kernel:
# every mLSTM block against its plain version on the same input along the
# route (chip_smoke.block_errors, beside BLOCK_NORM_TOL) and the bf16
# pooled features of xlstm-1.3b end to end, beside END_TO_END_TOL.  The
# repository itself is not touched.
#
# Run from the repository root:  bash tools/mlstm_mutant_check.sh [WORKDIR]
set -euo pipefail
MUT=${1:-$(mktemp -d)}
mkdir -p "$MUT"
rm -rf "$MUT/src"
cp -r src "$MUT/src"
rm -rf "$MUT/src/repro_torch/kernels/_build"
CU="$MUT/src/repro_torch/kernels/mlstm/csrc/mlstm.cu"
sed -i 's|const float decay_C = expf(w.MP\[bh \* nc + kc\] + A_c - m_new);|const float decay_C = 1.0f;|' "$CU"
grep -q "const float decay_C = 1.0f;" "$CU"
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
from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
from repro_torch.models import transformer

assert kernel.__file__.startswith(os.environ["MUT_SRC"]), kernel.__file__
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
out = {"norm_tol": chip_smoke.MLSTM_NORM_TOL}
for label, (B, H, S, D, c), long in (
        ("long_memory_bf16", (1, 4, 4096, 1024, 256), True),
        ("main_path_bf16", (8, 4, 4096, 1024, 256), False)):
    q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(3))
    f = (torch.full((B, H, S), -0.01, device="cuda") if long else
         torch.nn.functional.logsigmoid(
             torch.randn(B, H, S, device="cuda", generator=gen) + 2.0))
    i = torch.randn(B, H, S, device="cuda", generator=gen)
    h, p = kernel.mlstm(q, k, v, f, i, c), mlstm_chunkwise_ref(q, k, v, f, i, c)
    norm = chip_smoke.norm_rel(torch, h, p)
    out[label] = {"rel_max": chip_smoke.rel_err(torch, h, p)[1],
                  "norm_rel": norm,
                  "norm_rel_over_tol": norm / chip_smoke.MLSTM_NORM_TOL}
    del q, k, v, h, p
    torch.cuda.empty_cache()
# phase 8's check (c): agent 0's first batch, same seeds as chip_smoke.py
xl = configs.get_config("xlstm-1.3b")
params = transformer.init_model(
    torch.Generator(device="cuda").manual_seed(0), xl)
tokens = next(backbone.token_batches(
    torch.Generator(device="cuda").manual_seed(1), 1, n=8, seq=4096,
    m=4))[0][:1]
blocks = chip_smoke.block_errors(torch, params, xl, tokens[0])
f_k = pooled_features(params, xl, tokens)
f_p = pooled_features(params, xl, tokens, use_kernel=False)
norm = chip_smoke.norm_rel(torch, f_k, f_p)
out["check_c"] = {
    "blocks": blocks,
    "blocks_norm_rel_over_tol": blocks["norm_rel"]
    / chip_smoke.BLOCK_NORM_TOL["bf16"],
    "pooled_rel_max": chip_smoke.rel_err(torch, f_k, f_p)[1],
    "pooled_norm_rel": norm,
    "pooled_norm_rel_over_tol": norm / chip_smoke.END_TO_END_TOL[
        "xlstm-1.3b"]["bf16_norm_rel"]}
print("MUTANT", json.dumps(out))
PY
