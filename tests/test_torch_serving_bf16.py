"""Port parity of the serving path at the default bf16 caches: prefill
logits and every cache leaf, and a decode step from the reference's own
prefilled cache, within 3e-2 of max |reference| (``TOL["bf16"]``, the
reference's limit for bf16 against fp32 paths), on the smoke configs of
``test_torch_serving.py`` (which holds the same at fp32 caches, 1e-4)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

from test_torch_serving import (  # noqa: E402
    MODELS,
    check_decode_from_reference,
    check_prefill,
    make_models,
    make_ref_runs,
)


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def ref_runs(models):
    return make_ref_runs(models, ["bfloat16"])


@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_reference_bf16_cache(models, ref_runs, name):
    check_prefill(models[name], ref_runs[name, "bfloat16"], "bfloat16")


@pytest.mark.parametrize("name", MODELS)
def test_decode_from_the_reference_cache_bf16(models, ref_runs, name):
    check_decode_from_reference(models[name], ref_runs[name, "bfloat16"],
                                "bfloat16")
