"""Port parity: the launch layer (``repro_torch/launch/shapes.py``,
``launch/train.py``) and ``analysis/flops.py``, against the reference's on
every architecture of the registry at its full width: the input specs'
shapes and dtypes (the decode cache tree leaf by leaf, on the meta device
against ``jax.eval_shape``), the shape variants field for field, and the
analytic FLOPs exactly.  Then the training driver at smoke size on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.flops import analytic_cost as j_cost  # noqa: E402
from repro.configs import ARCH_NAMES as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch import analysis, configs  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

CASES = [(a, s) for a in J_ARCHS for s in jshapes.SHAPES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size training on one torch thread (as fast, and it does not
    fight JAX's threads or the other test workers for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.int8): torch.int8}


def _pair(arch, shape):
    return (jshapes.variant_for_shape(j_config(arch), jshapes.SHAPES[shape]),
            tshapes.variant_for_shape(configs.get_config(arch),
                                      tshapes.SHAPES[shape]))


def _same_leaf(got, want, where):
    assert isinstance(got, torch.Tensor) and got.device.type == "meta", where
    assert tuple(got.shape) == tuple(want.shape), where
    assert got.dtype == _DTYPES[jnp.dtype(want.dtype)], where


def _same_entry(got, want, where):
    """One layer's cache entry: a dict of lines by key, or a named tuple
    (a recurrent state, an int8 line) field by field."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_entry(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__, where
        assert got._fields == want._fields, where
        for f, g, w in zip(want._fields, got, want):
            _same_entry(g, w, f"{where}/{f}")
    else:
        _same_leaf(got, want, where)


def _unstack(entry):
    """One cycle of the reference's stacked cache entry (its shapes)."""
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                        entry)


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_match_the_reference(arch, shape):
    jc, tc = _pair(arch, shape)
    want = jshapes.input_specs(jc, jshapes.SHAPES[shape])
    got = tshapes.input_specs(tc, tshapes.SHAPES[shape])
    assert list(got) == list(want)
    for key in want:
        if key != "cache":
            _same_leaf(got[key], want[key], key)
    if "cache" not in want:
        return
    cache = want["cache"]
    _same_leaf(got["cache"]["pos"], cache["pos"], "pos")
    pattern = jc.block_pattern
    n_cycles = jc.n_layers // len(pattern)
    layers = got["cache"]["layers"]
    assert len(layers) == jc.n_layers
    for l, entry in enumerate(layers):
        if l < n_cycles * len(pattern):
            ref = _unstack(cache["cycles"][l % len(pattern)])
        else:
            ref = cache["rem"][l - n_cycles * len(pattern)]
        _same_entry(entry, ref, f"layer {l}")


@pytest.mark.parametrize("arch,shape", CASES)
def test_variant_for_shape_matches_the_reference(arch, shape):
    jc, tc = _pair(arch, shape)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.remat == (shape == "train_4k")


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_cost_equals_the_reference(arch, shape):
    jc, tc = _pair(arch, shape)
    assert analysis.analytic_cost(tc, tshapes.SHAPES[shape]) == \
        j_cost(jc, jshapes.SHAPES[shape])


def test_shapes_table_is_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_train_main_runs_on_the_cpu(arch, tmp_path):
    """The driver at smoke size: the reference's log keys on every row, a
    finite loss, the checkpoint written at the end and every
    ``--ckpt-every`` steps, and the log file."""
    log_file = tmp_path / "log.json"
    log = ttrain.main(["--arch", arch, "--smoke", "--steps", "4",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ckpt"),
                       "--ckpt-every", "2", "--log-file", str(log_file)])
    assert len(log) == 4
    for row in log:
        assert {"step", "loss", "ce", "grad_norm", "seconds"} <= set(row)
        assert np.isfinite(row["loss"]) and row["grad_norm"] > 0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_00000002", "step_00000004"]
    assert log_file.exists()
