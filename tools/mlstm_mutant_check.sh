#!/bin/bash
# Mutation check of the mlstm gates in chip_smoke.py, on one CUDA card.
#
# Copies src/ twice into WORKDIR (default: a fresh temporary directory) and
# breaks each copy's bf16 body (the tensor-core grids of mlstm.cu):
#   decay_C   the carried state does not decay across chunk boundaries
#             (decay_C forced to 1 in the states grid);
#   one_term  both split operands (w v and the stored states C) enter the
#             tensor cores as one bf16 term each, their low terms dropped.
# Each copy is built and prints one JSON line "MUTANT {...}": the broken
# kernel against its plain version at phase 8's call (bf16) and in phase 3's
# long-memory case (log_f = -0.01), as max |h - plain| / max |plain| and
# ||h - plain|| / ||plain|| beside MLSTM_NORM_TOL, with the body and terms
# the call ran; for decay_C also phase 8's check (c) with the broken kernel:
# every mLSTM block against its plain version on the same input along the
# route (chip_smoke.block_errors, beside BLOCK_NORM_TOL) and the bf16
# pooled features of xlstm-1.3b end to end, beside END_TO_END_TOL.  The
# repository itself is not touched.
#
# Run from the repository root:  bash tools/mlstm_mutant_check.sh [WORKDIR]
set -euo pipefail
WORK=${1:-$(mktemp -d)}

# mutant NAME OLD NEW [OLD NEW ...]: a copy of src/ in WORK/NAME with each
# OLD (found once in mlstm.cu) replaced by its NEW
mutant() {
  local dir="$WORK/$1" cu
  mkdir -p "$dir"
  rm -rf "$dir/src"
  cp -r src "$dir/src"
  rm -rf "$dir/src/repro_torch/kernels/_build"
  cu="$dir/src/repro_torch/kernels/mlstm/csrc/mlstm.cu"
  shift
  while [ $# -gt 0 ]; do
    test "$(grep -cF -- "$1" "$cu")" = 1
    OLD="$1" NEW="$2" python3 - "$cu" <<'PY'
import os
import sys

path = sys.argv[1]
text = open(path).read()
open(path, "w").write(text.replace(os.environ["OLD"], os.environ["NEW"]))
PY
    grep -qF -- "$2" "$cu"
    shift 2
  done
}

mutant decay_C \
  "      decay_C = expf(w.MP[bh * nc + kc] + A[t0 + c - 1] - M[t0 + c - 1]);" \
  "      decay_C = 1.0f;"
mutant one_term \
  "constexpr int WV_SPLIT = 2;" "constexpr int WV_SPLIT = 1;" \
  "constexpr int C_SPLIT = 2;" "constexpr int C_SPLIT = 1;"

for name in decay_C one_term; do
MUT_SRC="$WORK/$name/src" MUT_NAME="$name" python3 - <<'PY'
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
out = {"mutant": os.environ["MUT_NAME"], "norm_tol": chip_smoke.MLSTM_NORM_TOL}
for label, (B, H, S, D, c), long in (
        ("main_path_bf16", (8, 4, 4096, 1024, 256), False),
        ("long_memory_bf16", (1, 4, 4096, 1024, 256), True)):
    q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(3))
    f = (torch.full((B, H, S), -0.01, device="cuda") if long else
         torch.nn.functional.logsigmoid(
             torch.randn(B, H, S, device="cuda", generator=gen) + 2.0))
    i = torch.randn(B, H, S, device="cuda", generator=gen)
    h = kernel.mlstm(q, k, v, f, i, c)
    ran = dict(kernel.LAST_MLSTM)
    p = mlstm_chunkwise_ref(q, k, v, f, i, c)
    norm = chip_smoke.norm_rel(torch, h, p)
    out[label] = {"ran": ran, "rel_max": chip_smoke.rel_err(torch, h, p)[1],
                  "norm_rel": norm,
                  "norm_rel_over_tol": norm / chip_smoke.MLSTM_NORM_TOL}
    del q, k, v, h, p
    torch.cuda.empty_cache()
if os.environ["MUT_NAME"] == "decay_C":
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
print("MUTANT", json.dumps(out), flush=True)
PY
done
