"""Port parity: the xLSTM blocks (``repro_torch/models/xlstm.py``), the
xlstm-1.3b config and its model through ``encode`` and ``pooled_features``.

The reference's weights carry into the port (``convert``), the same numpy
inputs go through both packages, and the port runs on CPU tensors (the
``mlstm`` kernel's plain version).  Blocks agree within 1e-5 in fp32 and
3e-2 of max |reference| in bf16: in bf16 the reference's model path rounds
the gated scores to bf16 before S V and returns h in bf16, where the port
(as the TPU kernel) keeps both in fp32.  Shapes are checked against the
reference's ``jax.eval_shape`` at full width.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import heads as jh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import heads as th  # noqa: E402
from repro_torch.kernels.mlstm import kernel as mlstm_kernel  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

NAME = "xlstm-1.3b"
S = 40              # five chunks of the smoke config's 8 steps
FULL_PARAMS = 3_502_094_672


def _cfgs(**kw):
    return (dataclasses.replace(j_smoke(NAME), **kw),
            dataclasses.replace(configs.get_smoke_config(NAME), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _paths(tree, prefix=()):
    """{key path: leaf} of nested dicts (the port's and the reference's
    pytrees alike)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_match_reference(block, dtype):
    jc, tc = _cfgs(dtype=dtype)
    init, apply = {"mlstm": (jx.mlstm_init, jx.mlstm_block),
                   "slstm": (jx.slstm_init, jx.slstm_block)}[block]
    jp = init(jax.random.PRNGKey(5), jc)
    tp = convert._tree_tensors(_np_tree(jp), "cpu")
    x = np.random.default_rng(5).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    want, _ = apply(jp, jc, jnp.asarray(x, jdt), None)
    got, _ = getattr(tx, f"{block}_block")(tp, tc, torch.tensor(x).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert _rel(got, want.astype(jnp.float32)) <= 3e-2


def test_blocks_refuse_a_carried_state():
    """A carried state must be the block's own state tuple: an object of
    another type (here the other block's state) is refused."""
    _, tc = _cfgs()
    x = torch.zeros(1, 3, tc.d_model)
    gen = torch.Generator().manual_seed(0)
    _, m_state = tx.mlstm_block(tx.mlstm_init(gen, tc), tc, x,
                                final_state=True)
    _, s_state = tx.slstm_block(tx.slstm_init(gen, tc), tc, x)
    for block, other in (("mlstm", s_state), ("slstm", m_state)):
        params = getattr(tx, f"{block}_init")(gen, tc)
        with pytest.raises(TypeError, match="State or None"):
            getattr(tx, f"{block}_block")(params, tc, x, state=other)
        with pytest.raises(TypeError, match="State or None"):
            getattr(tx, f"{block}_block")(params, tc, x, state=object())


def test_config_and_full_width_shapes_match_the_reference():
    """The full config field for field, and every leaf of one mLSTM and one
    sLSTM block at full width against the reference's ``eval_shape``: 48
    layers (6 cycles of 7 mLSTM + 1 sLSTM), 3.502e9 parameters."""
    cfg, jcfg = configs.get_config(NAME), j_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kinds = cfg.layer_kinds()
    assert (len(kinds), kinds.count("mlstm"), kinds.count("slstm")) == \
        (48, 42, 6)
    shapes = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    assert len(shapes["cycles"]) == 8 and shapes["rem"] == ()
    gen = torch.Generator().manual_seed(0)
    count = cfg.vocab_size * cfg.d_model + cfg.d_model   # embed, final norm
    for j, kind in ((0, "mlstm"), (7, "slstm")):
        block = tt.block_init(gen, cfg, kind)
        want = _paths(shapes["cycles"][j])
        got = _paths(block)
        assert set(got) == set(want)
        for path, leaf in got.items():
            assert (6,) + tuple(leaf.shape) == want[path].shape, path
        count += kinds.count(kind) * tt.param_count(block)
        del block
    assert count == FULL_PARAMS == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_init_model_matches_the_reference_layout():
    """One cycle of the full pattern plus two remainder blocks at smoke
    width: the port's flat layer list against the reference's shapes, in
    layer order."""
    jc, tc = _cfgs(n_layers=10, block_pattern=j_config(NAME).block_pattern)
    p = tt.init_model(torch.Generator().manual_seed(0), tc)
    shapes = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jc))
    want = ([jax.tree.map(lambda s: s.shape[1:], b) for b in shapes["cycles"]]
            + [jax.tree.map(lambda s: s.shape, b) for b in shapes["rem"]])
    assert [set(layer) for layer in p["layers"]] == \
        [{"ln1", kind} for kind in tc.layer_kinds()]
    for layer, ref in zip(p["layers"], want):
        ref = _paths(ref)
        got = _paths(layer)
        assert set(got) == set(ref)
        assert all(tuple(t.shape) == tuple(ref[k]) for k, t in got.items())
    assert tt.param_count(p) == sum(int(np.prod(x.shape))
                                    for x in jax.tree.leaves(shapes))
    assert all(t.dtype == torch.float32 for t in tt._leaves(p))


def test_model_from_numpy_unstacks_two_cycles():
    """A 2-cycle (mlstm, slstm) model: layer 2c + j is cycle c, block j,
    nested leaves (w_if {w, b}, r {w}, b {b}) included."""
    jc, tc = _cfgs(n_layers=4)
    jp = jt.init_model(jax.random.PRNGKey(1), jc)
    tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    assert len(tp["layers"]) == 4 and jp["rem"] == ()
    for li, layer in enumerate(tp["layers"]):
        c, j = divmod(li, 2)
        ref = _paths(_np_tree(jp["cycles"][j]))
        got = _paths(layer)
        assert set(got) == set(ref)
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), ref[path][c])
    assert tp["layers"][1]["slstm"]["r"]["w"].shape == (4, 32, 128)
    assert tp["layers"][0]["mlstm"]["w_if"]["b"].shape == (8,)


@pytest.mark.parametrize("dtype,n_layers", [("float32", 4), ("bfloat16", 2)])
def test_encode_and_pooled_features_match(dtype, n_layers):
    """fp32 through two cycles within 1e-4; bf16 through the smoke config's
    one cycle within 3e-2.  bf16 rounding alone moves the reference's own
    encode from its fp32 encode by 1.8e-2 after one cycle and 6.1e-2 after
    two, so a bf16 gate over two cycles would hold roundoff, not the port."""
    jc, tc = _cfgs(n_layers=n_layers, dtype=dtype)
    jp = jt.init_model(jax.random.PRNGKey(2), jc)
    tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 3, S))
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    mlstm_kernel.reset_launches()
    want = jt.encode(jp, jc, jnp.asarray(tokens[0])).astype(jnp.float32)
    got = tt.encode(tp, tc, torch.tensor(tokens[0]))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert _rel(got, want) <= tol
    want = jh.pooled_features(jp, jc, jnp.asarray(tokens))
    got = th.pooled_features(tp, tc, torch.tensor(tokens))
    assert got.shape == (2, 3, tc.d_model) and got.dtype == torch.float32
    assert _rel(got, want) <= tol
    assert mlstm_kernel.LAUNCHES["mlstm"] == 0   # CPU: the plain version
