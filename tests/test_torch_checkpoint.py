"""Port parity: checkpoints of consensus runs (``repro_torch.checkpoint``)
against the JAX reference's store, and the port's bitwise resume.

* On the CPU a resumed run equals the uninterrupted run bit for bit, state
  and every diagnostics key, for the dense and the colored (staleness 2)
  executor on ``paper_fig2a()`` and ``star(5)``; once with a real kill
  (``REPRO_CHECKPOINT_EXIT_AFTER_SAVE``) in a subprocess.
* Checkpoints cross between the packages in both directions: a port
  checkpoint reads in the reference with the keys, key order and dtype
  strings of the reference's own; a reference checkpoint restores into the
  port's ``RunState`` and resumes to the reference's final U·A, objective
  and predictions at r = 1 (atol 1e-4 on U·A and predictions, rtol 1e-4 on
  the objective; ROADMAP queue 3).  bfloat16 leaves cross bit for bit.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.checkpoint import checkpoint as jck_store  # noqa: E402
from repro.core import dmtl_elm as jd  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck_store  # noqa: E402
from repro_torch.core import dmtl_elm as td  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAPHS = {"paper_fig2a": (), "star": (5,)}
EXECUTORS = {"dense": {}, "colored2": dict(executor="colored", staleness=2)}


def _data(m, N=20, L=10, d=2, seed=0):
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, d)).astype(np.float32)
    return H, T


def _graphs(name):
    return getattr(tg, name)(*GRAPHS[name]), getattr(jg, name)(*GRAPHS[name])


def _same_run(got, want):
    (st, d), (st0, d0) = got, want
    for a, b in zip(st, st0):
        assert torch.equal(a, b)
    assert set(d) == set(d0)
    for key in d0:
        assert torch.equal(d[key], d0[key]), key


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------


class Pair(NamedTuple):
    b: object
    a: object


def _tree(leaf):
    """One tree of every container kind, unsorted dict keys, a None."""
    return {"z": leaf(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "B": [leaf(np.int32(7)), None, leaf(np.zeros((0, 2), np.float64))],
            "a": Pair(b=leaf(np.ones(3, np.int8)),
                      a={"y": leaf(np.float64(2.5)), "x": None})}


def test_flatten_order_and_names_are_the_references():
    names_t = [n for n, _ in tck_store._flatten_with_names(_tree(torch.tensor))]
    names_j = [n for n, _ in jck_store._flatten_with_names(_tree(np.asarray))]
    assert names_t == names_j


def test_port_store_round_trips_and_the_reference_reads_it(tmp_path):
    tree = _tree(torch.tensor)
    tck.save_checkpoint(tmp_path, 3, tree, metadata={"note": 1})
    got, meta = tck.load_checkpoint(tmp_path, tree)
    assert meta["step"] == 3 and meta["metadata"] == {"note": 1}
    flat_got = tck_store._flatten_with_names(got)
    for (n, a), (_, b) in zip(flat_got, tck_store._flatten_with_names(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert got["B"][1] is None and isinstance(got["a"], Pair)
    raw, jmeta = jck.load_checkpoint(tmp_path, None)
    assert jmeta == meta == tck.read_meta(tmp_path) == jck.read_meta(tmp_path)
    for name, leaf in tck_store._flatten_with_names(tree):
        np.testing.assert_array_equal(raw[name], leaf.numpy())
        assert raw[name].dtype == leaf.numpy().dtype
    # a leaf of the wrong shape is refused
    with pytest.raises(ValueError, match="shape"):
        tck.load_checkpoint(tmp_path, dict(tree, z=torch.zeros(3, 2)))


def test_bfloat16_crosses_bit_for_bit_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    x[0, :3] = [np.inf, -0.0, np.nan]
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    # port -> reference
    tck.save_checkpoint(tmp_path / "p", 0, {"w": t, "f": torch.tensor(x)})
    raw, meta = jck.load_checkpoint(tmp_path / "p", None)
    assert meta["dtypes"] == {"f": "float32", "w": "bfloat16"}
    assert raw["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(raw["w"].view(np.uint16), bits)
    # reference -> port, raw and through a template
    jck.save_checkpoint(tmp_path / "j", 0,
                        {"w": jnp.asarray(x.astype(ml_dtypes.bfloat16))})
    assert jck.read_meta(tmp_path / "j")["dtypes"] == {"w": "bfloat16"}
    for got in (tck.load_checkpoint(tmp_path / "j")[0]["w"],
                tck.load_checkpoint(tmp_path / "j",
                                    {"w": torch.zeros(4, 5)})[0]["w"]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), bits)
    # and the port reads back its own
    got = tck.load_checkpoint(tmp_path / "p")[0]["w"]
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))


# --------------------------------------------------------------------------
# bitwise resume on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_resumed_run_is_bitwise_the_uninterrupted_run(graph, executor,
                                                      tmp_path):
    g, _ = _graphs(graph)
    H, T = (torch.tensor(a) for a in _data(g.m, seed=len(graph)))
    cfg = te.ConsensusConfig(r=2, iters=12, tau=2.0, zeta=1.0)
    kw = dict(EXECUTORS[executor], checkpoint_dir=tmp_path,
              checkpoint_every=4)
    want = td.fit(H, T, g, cfg, **EXECUTORS[executor])
    # stopped at 6: snapshots at 4 and 6, then segments 6-10 and 10-12
    td.fit(H, T, g, te.ConsensusConfig(r=2, iters=6, tau=2.0, zeta=1.0),
           **kw)
    assert tck.latest_step(tmp_path) == 6
    tracer = tobs.Tracer()
    with tobs.use(tracer):
        got = td.fit(H, T, g, cfg, resume=True, **kw)
    _same_run(got, want)
    assert [s["name"] for s in tracer.spans].count("restore") == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000006", "step_00000010", "step_00000012"]
    # a resume from the last snapshot runs nothing more
    _same_run(td.fit(H, T, g, cfg, resume=True, **kw), want)


def test_resume_after_a_real_kill(tmp_path):
    """The child process dies (``os._exit(0)``) right after its save at
    step 6; the parent resumes from disk."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import numpy as np, torch
        from repro_torch.core import dmtl_elm, engine, graph
        rng = np.random.default_rng(0)
        H = (rng.standard_normal((5, 20, 10)) / np.sqrt(10)).astype(np.float32)
        T = rng.standard_normal((5, 20, 2)).astype(np.float32)
        dmtl_elm.fit(torch.tensor(H), torch.tensor(T), graph.paper_fig2a(),
                     engine.ConsensusConfig(r=2, iters=12, tau=2.0, zeta=1.0),
                     checkpoint_dir={str(tmp_path)!r}, checkpoint_every=3)
        sys.exit(3)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=300,
        env={**os.environ, "REPRO_CHECKPOINT_EXIT_AFTER_SAVE": "6"})
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]
    H, T = (torch.tensor(a) for a in _data(5))
    g = tg.paper_fig2a()
    cfg = te.ConsensusConfig(r=2, iters=12, tau=2.0, zeta=1.0)
    got = td.fit(H, T, g, cfg, checkpoint_dir=tmp_path, checkpoint_every=3,
                 resume=True)
    _same_run(got, td.fit(H, T, g, cfg))


def test_resume_with_another_executor_is_refused(tmp_path):
    H, T = (torch.tensor(a) for a in _data(5))
    g = tg.paper_fig2a()
    cfg = te.ConsensusConfig(r=2, iters=4)
    td.fit(H, T, g, cfg, checkpoint_dir=tmp_path, checkpoint_every=2)
    with pytest.raises(ValueError, match="written by executor 'dense'"):
        td.fit(H, T, g, cfg, executor="colored", checkpoint_dir=tmp_path,
               resume=True)
    runner = te.make_runner(te.sufficient_stats(H, T), g, cfg,
                            executor="colored", staleness=2)
    with pytest.raises(ValueError, match="lacks state leaf 'hist'"):
        tck.load_run_checkpoint(tmp_path, runner.init_state())
    small = te.make_runner(te.sufficient_stats(H[..., :4], T), g, cfg)
    with pytest.raises(ValueError, match="shape"):
        tck.load_run_checkpoint(tmp_path, small.init_state())


def test_checkpoint_every_zero_saves_once_and_resume_starts_fresh(tmp_path):
    H, T = (torch.tensor(a) for a in _data(5))
    g = tg.paper_fig2a()
    cfg = te.ConsensusConfig(r=2, iters=5)
    got = td.fit(H, T, g, cfg, checkpoint_dir=tmp_path / "c", resume=True)
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "step_00000005"]
    _same_run(got, td.fit(H, T, g, cfg))
    state, diags, meta = tck.load_run_checkpoint(
        tmp_path / "c", te.make_runner(te.sufficient_stats(H, T), g,
                                       cfg).init_state())
    assert state.k == 5 and meta["metadata"] == {"executor": "dense",
                                                 "iters": 5}
    for key in diags:
        assert torch.equal(diags[key], got[1][key])


# --------------------------------------------------------------------------
# both directions across the packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_port_checkpoint_has_the_references_layout(executor, tmp_path):
    H, T = _data(5)
    kw = EXECUTORS[executor]
    cfg = dict(r=1, iters=6, tau=2.0, zeta=1.0)
    td.fit(torch.tensor(H), torch.tensor(T), tg.paper_fig2a(),
           te.ConsensusConfig(**cfg), checkpoint_dir=tmp_path / "t",
           checkpoint_every=3, **kw)
    jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
           je.ConsensusConfig(**cfg), checkpoint_dir=tmp_path / "j",
           checkpoint_every=3, **kw)
    meta_t, meta_j = (jck.read_meta(tmp_path / x) for x in "tj")
    assert meta_t == meta_j == tck.read_meta(tmp_path / "t")
    assert meta_t["keys"] == list(meta_t["dtypes"])
    raw_j, _ = jck.load_checkpoint(tmp_path / "t", None)
    raw_t, _ = tck.load_checkpoint(tmp_path / "t")
    assert list(raw_j) == list(raw_t) == meta_t["keys"]
    for name in raw_t:
        assert str(raw_j[name].dtype) == meta_t["dtypes"][name]
        np.testing.assert_array_equal(raw_j[name], raw_t[name].numpy())
    # and the reference resumes the port's run to its own end
    st_j, d_j = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
                       je.ConsensusConfig(**dict(cfg, iters=10)),
                       checkpoint_dir=tmp_path / "t", checkpoint_every=3,
                       resume=True, **kw)
    st_0, d_0 = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
                       je.ConsensusConfig(**dict(cfg, iters=10)), **kw)
    np.testing.assert_allclose(np.asarray(st_j.U @ st_j.A),
                               np.asarray(st_0.U @ st_0.A), atol=1e-4)
    np.testing.assert_allclose(np.asarray(d_j["objective"]),
                               np.asarray(d_0["objective"]), rtol=1e-4)


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_reference_checkpoint_resumes_in_the_port(executor, tmp_path):
    H, T = _data(5, seed=2)
    H_te, _ = _data(5, N=7, seed=3)
    kw = EXECUTORS[executor]
    cfg = dict(r=1, iters=12, tau=2.0, zeta=1.0)
    jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
           je.ConsensusConfig(**dict(cfg, iters=5)),
           checkpoint_dir=tmp_path, checkpoint_every=5, **kw)
    st_j, d_j = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
                       je.ConsensusConfig(**cfg), **kw)
    st_t, d_t = td.fit(torch.tensor(H), torch.tensor(T), tg.paper_fig2a(),
                       te.ConsensusConfig(**cfg), checkpoint_dir=tmp_path,
                       checkpoint_every=5, resume=True, **kw)
    assert set(d_t) == set(d_j) and d_t["objective"].shape == (12,)
    # the prefix is the reference's own, bit for bit
    np.testing.assert_array_equal(d_t["objective"][:5].numpy(),
                                  np.asarray(d_j["objective"])[:5])
    np.testing.assert_allclose((st_t.U @ st_t.A).numpy(),
                               np.asarray(st_j.U @ st_j.A), atol=1e-4)
    np.testing.assert_allclose(d_t["objective"].numpy(),
                               np.asarray(d_j["objective"]), rtol=1e-4)
    pred_t = td.dmtl_elm_predict(st_t.U, st_t.A, torch.tensor(H_te))
    pred_j = jd.dmtl_elm_predict(st_j.U, st_j.A, jnp.asarray(H_te))
    scale = float(np.abs(np.asarray(pred_j)).max())
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=1e-4 * scale)


@pytest.mark.parametrize("staleness", [0, 2])
def test_remap_membership_matches_reference(staleness):
    H, T = _data(5)
    g5 = tg.ring(5)
    runner = te.make_runner(te.sufficient_stats(torch.tensor(H),
                                                torch.tensor(T)), g5,
                            te.ConsensusConfig(r=2, iters=4),
                            executor="colored", staleness=staleness)
    state, _ = runner.run()
    jstate = je.RunState(U=jnp.asarray(state.U.numpy()),
                         A=jnp.asarray(state.A.numpy()),
                         lam=jnp.asarray(state.lam.numpy()),
                         k=jnp.asarray(state.k, jnp.int32),
                         hist=jnp.asarray(state.hist.numpy()))
    for new, jnew in ((tg.ring(5), jg.ring(5)), (tg.ring(7), jg.ring(7)),
                      (tg.ring(3), jg.ring(3)), (tg.star(6), jg.star(6))):
        got = tck.remap_membership(state, g5, new)
        want = jck.remap_membership(jstate, jg.ring(5), jnew)
        assert got.k == state.k
        for name in ("U", "A", "lam", "hist"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
    same = tck.remap_membership(state, g5, g5)
    for a, b in zip(same, state):
        if a is None or isinstance(a, int):
            assert a == b
        else:
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the health monitor, and the quickstart's resume mode
# --------------------------------------------------------------------------


def test_health_early_stop_matches_reference(tmp_path):
    H, T = _data(4)
    hc = dict(stall_window=2, stall_tol=10.0, consensus_floor=0.0)
    cfg = dict(r=2, iters=10)
    _, d_t = td.fit(torch.tensor(H), torch.tensor(T), tg.ring(4),
                    te.ConsensusConfig(**cfg), checkpoint_dir=tmp_path / "t",
                    checkpoint_every=2, health=tobs.HealthConfig(**hc))
    _, d_j = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.ring(4),
                    je.ConsensusConfig(**cfg), checkpoint_dir=tmp_path / "j",
                    checkpoint_every=2, health=tobs.HealthConfig(**hc))
    n_done = int(d_t["objective"].shape[0])
    assert n_done == int(np.asarray(d_j["objective"]).shape[0]) < 10
    assert n_done % 2 == 0
    meta_t = tck.read_meta(tmp_path / "t")["metadata"]
    assert meta_t == jck.read_meta(tmp_path / "j")["metadata"]
    assert meta_t["dnf_reason"] == "consensus_stall"


def test_healthy_monitored_run_is_bitwise_unmonitored(tmp_path):
    H, T = (torch.tensor(a) for a in _data(4))
    g, cfg = tg.ring(4), te.ConsensusConfig(r=2, iters=6)
    got = td.fit(H, T, g, cfg, checkpoint_dir=tmp_path, checkpoint_every=2,
                 health=tobs.HealthConfig(stall_window=1000))
    _same_run(got, td.fit(H, T, g, cfg))
    got = td.fit(H, T, g, cfg, checkpoint_dir=tmp_path / "x", health=True)
    _same_run(got, td.fit(H, T, g, cfg))


def test_quickstart_resume_mode(tmp_path, capsys):
    out = quickstart.resume_demo(tmp_path / "ck", iters=30, interrupt_at=10,
                                 checkpoint_every=4, device="cpu")
    assert "bitwise identical" in capsys.readouterr().out
    assert out["diags"]["objective"].shape == (30,)
