"""Port parity: ``repro_torch.netsim`` (tapes, channels, adversaries, the
async executor), the robust aggregators and the tape gather against the JAX
reference on the same numpy inputs, and the identities the port claims for
itself.

Tolerances: tapes, ``coordinate_median``, ``krum_like``, ``apply_attack``
and ``aggregator_audit`` exactly; ``trimmed_mean`` at rtol 1e-6 (its sum
adds in another order); the tape gather's views at 1e-6; ``fit_async`` at
r = 1 (the all-ones start is symmetric in U's columns, ROADMAP queue 3)
over 12 ticks: objective and lagrangian at rtol 1e-4, U·A and predictions
at rtol/atol 1e-4, consensus at rtol 1e-3.  ``krum_like``'s argmin is
discontinuous (a roundoff tie flips it), so it is compared at the
aggregator level only; end to end it must be finite with every key.

The reference's own bitwise oracles (constant tape ≡ stale colored sweep,
all-dropped ≡ stale, ...) fail on this toolchain's jax (ROADMAP queue 3),
so those identities are held inside ``repro_torch`` only, where on CPU
tensors they hold bit for bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import netsim as jn  # noqa: E402
from repro.core import dmtl_elm as jd  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import exchange as jx  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import netsim as tn  # noqa: E402
from repro_torch.core import dmtl_elm as td  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import exchange as tx  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRACE = ROOT / "experiments" / "traces" / "wan_pareto_40ms.csv"
GRAPHS = {"paper_fig2a": (), "ring": (6,), "star": (5,)}
ROBUST = ("trimmed_mean", "coordinate_median", "krum_like")
ASYNC_KEYS = set(te.DIAG_KEYS) | {"tape_cursor"}
ITERS, L_FIT = 12, 12


def _graphs(name):
    return getattr(tg, name)(*GRAPHS[name]), getattr(jg, name)(*GRAPHS[name])


def _data(m, N=24, L=L_FIT, d=3, seed=0):
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, d)).astype(np.float32)
    return H, T


def _stats(m, seed=0, **kw):
    H, T = _data(m, seed=seed, **kw)
    sj = je.sufficient_stats(jnp.asarray(H), jnp.asarray(T))
    return sj, convert.stats_from_numpy(sj.G, sj.R, sj.n, sj.t2,
                                        device="cpu")


def _same_arrays(a, b):
    """Two tapes (or any NamedTuples of arrays) equal field for field."""
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _same_run(got, want, keys=None):
    (st, d), (st0, d0) = got, want
    for a, b in zip(st, st0):
        assert torch.equal(a, b)
    for key in (keys if keys is not None else d0):
        assert torch.equal(d[key], d0[key]), key


# --------------------------------------------------------------------------
# tapes: the reference's arrays, for the same seed and graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_tape_constructors_match_reference(graph):
    gt, gj = _graphs(graph)
    _same_arrays(tn.zero_delay_tape(10, gt), jn.zero_delay_tape(10, gj))
    for k in (1, 3, 30):
        t, j = tn.constant_tape(10, gt, k), jn.constant_tape(10, gj, k)
        _same_arrays(t, j)
        assert t.depth == j.depth
    with pytest.raises(ValueError, match=">= 1"):
        tn.constant_tape(10, gt, 0)


@pytest.mark.parametrize("delay", tn.DELAY_KINDS)
@pytest.mark.parametrize("graph", ["paper_fig2a", "star"])
def test_channel_sample_matches_reference(graph, delay):
    gt, gj = _graphs(graph)
    kw = dict(delay=delay, scale=2.0, drop=0.2, straggler_prob=0.3,
              straggler_mean=2.0, seed=7)
    t = tn.ChannelModel(**kw).sample(gt, 25)
    _same_arrays(t, jn.ChannelModel(**kw).sample(gj, 25))
    assert tn.tape_summary(t) == jn.tape_summary(t)
    np.testing.assert_array_equal(
        tn.ChannelModel(**kw).quantiles((0.5, 0.9, 0.99), n=500, seed=3),
        jn.ChannelModel(**kw).quantiles((0.5, 0.9, 0.99), n=500, seed=3))


def test_all_dropped_channel_and_arrivals_match_reference():
    g, gj = _graphs("paper_fig2a")
    _same_arrays(tn.ChannelModel(drop=1.0).sample(g, 9),
                 jn.ChannelModel(drop=1.0).sample(gj, 9))
    rng = np.random.default_rng(3)
    arrival = np.arange(8.0)[:, None] + 1 + rng.integers(0, 4, (8, 5))
    arrival[rng.uniform(size=arrival.shape) < 0.3] = np.inf
    np.testing.assert_array_equal(tn.ages_from_arrivals(arrival),
                                  jn.ages_from_arrivals(arrival))


@pytest.mark.parametrize("kind", list(tn.ATTACK_KINDS))
def test_adversary_sample_matches_reference(kind):
    """Each attack kind over a lossy base tape, with scheduled churn and a
    random leave walk: every field the reference's, bit for bit."""
    gt, gj = _graphs("ring")
    base = tn.ChannelModel(delay="geometric", scale=1.5, drop=0.1,
                           straggler_prob=0.2, seed=4).sample(gt, 20)
    kw = dict(n_byzantine=2, attack_rate=0.7, kinds=(kind,), noise_scale=0.3,
              offset_scale=0.5, churn=((1, 3, 9), (4, 12, -1)),
              leave_prob=0.1, mean_absence=2.0, seed=5)
    t = tn.AdversaryModel(**kw).sample(gt, 20, L=6, r=2, base=base)
    _same_arrays(t, jn.AdversaryModel(**kw).sample(gj, 20, L=6, r=2,
                                                   base=base))
    assert (t.attack == tn.ATTACK_KINDS[kind]).any()
    assert (t.member == 0.0).any()
    _same_arrays(tn.zero_adversary_tape(base, 6, 2),
                 jn.zero_adversary_tape(base, 6, 2))


def test_from_trace_matches_reference():
    t, j = tn.from_trace(TRACE), jn.from_trace(TRACE)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.delay == "heavy_tail" and tn.TRACE_QUANTILES == \
        jn.TRACE_QUANTILES
    gt, gj = _graphs("ring")
    _same_arrays(t.sample(gt, 12), j.sample(gj, 12))


def _broken_tapes(g):
    """The reference's broken-invariant cases, as (tape, iters, match)."""
    good = tn.constant_tape(8, g, 2)
    age = good.age.copy()
    age[0, 0, 0] = 5
    old = tn.EventTape(age=age, active=good.active)
    age = good.age.copy()
    age[5, 1, 2], age[6, 1, 2] = 1, 4
    jump = tn.EventTape(age=age, active=good.active)
    act = good.active.copy()
    act[3, 1] = 0.5
    churned = tn.AdversaryModel(churn=((2, 1, 5),)).sample(g, 8, L=4, r=2)
    bad_attack = churned.attack.copy()
    bad_attack[2, 2] = tn.ATTACK_KINDS["sign_flip"]
    lagged = tn.ChannelModel(delay="deterministic", scale=3.0).sample(g, 16)
    flushed = tn.AdversaryModel(churn=((1, 5, 9),)).sample(g, 16, L=4, r=2,
                                                           base=lagged)
    return [
        (good, 9, "ticks"),
        (tn.EventTape(age=good.age * 0, active=good.active), 8, ">= 1"),
        (old, 8, "k \\+ 1"),
        (jump, 8, "more than 1"),
        (tn.EventTape(age=good.age, active=act), 8, "mask"),
        (churned._replace(attack=bad_attack), 8, "cannot attack"),
        (churned._replace(active=np.ones_like(churned.active)), 8,
         "cannot compute"),
        (flushed._replace(age=lagged.age), 16, "non-member"),
    ]


def test_validate_tape_rejects_what_the_reference_rejects():
    gt, gj = _graphs("ring")
    with pytest.raises(ValueError, match="E="):
        tn.validate_tape(tn.constant_tape(8, gt, 2), tg.star(4), 8)
    for tape, iters, match in _broken_tapes(gt):
        with pytest.raises(ValueError, match=match):
            tn.validate_tape(tape, gt, iters)
        with pytest.raises(ValueError, match=match):
            jn.validate_tape(tape, gj, iters)
    # a resumed suffix is validated against its absolute ticks
    tape = tn.ChannelModel(drop=1.0).sample(gt, 10)
    suffix = tn.EventTape(age=tape.age[4:], active=tape.active[4:])
    tn.validate_tape(suffix, gt, start=4)
    jn.validate_tape(suffix, gj, start=4)
    for pkg, g in ((tn, gt), (jn, gj)):
        with pytest.raises(ValueError, match="k \\+ 1"):
            pkg.validate_tape(suffix, g, start=2)


def test_models_refuse_what_the_reference_refuses():
    for bad in (dict(delay="uniform"), dict(scale=-1.0), dict(drop=1.5),
                dict(straggler_prob=-0.1), dict(straggler_mean=0.5),
                dict(alpha=1.0)):
        for pkg in (tn, jn):
            with pytest.raises(ValueError):
                pkg.ChannelModel(**bad)
    for bad in (dict(n_byzantine=-1), dict(attack_rate=1.5),
                dict(kinds=("bogus",)), dict(noise_scale=-0.1),
                dict(churn=((0, 3, 2),)), dict(leave_prob=2.0),
                dict(mean_absence=0.5)):
        for pkg in (tn, jn):
            with pytest.raises(ValueError):
                pkg.AdversaryModel(**bad)
    with pytest.raises(ValueError, match="exceeds"):
        tn.AdversaryModel(n_byzantine=7).sample(tg.ring(6), 5, L=4, r=2)


def test_frontier_helpers_match_reference():
    rng = np.random.default_rng(2)
    objs = np.sort(rng.uniform(0.1, 10.0, 30))[::-1].copy()
    for at, slack in ((4, 1e-3), (100, 1e-2)):
        assert tn.gap_target(objs, at, slack) == jn.gap_target(objs, at,
                                                               slack)
    for o, target in ((objs, float(objs[12])), (objs, 0.0),
                      (np.array([10.0, 5.0, np.nan, 1.0]), 6.0),
                      (np.array([10.0, 5.0, np.nan, 1.0]), 2.0),
                      (np.array([10.0, 8.0, -np.inf, 0.1]), 1.0),
                      (np.array([3.0, 2.0]), np.nan)):
        assert tn.iters_to_target(o, target) == jn.iters_to_target(o, target)
    assert tn.iters_to_target(np.array([10.0, 8.0, -np.inf]), 1.0) == -1


# --------------------------------------------------------------------------
# the robust aggregators, the attack chain and the audit
# --------------------------------------------------------------------------


def _candidates(seed=0, m=6, K=5, L=7, r=3):
    """(m, K, L, r) views, with padded rows and agents with fewer than 3
    valid candidates, and an outlier for the audit to find."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, K, L, r)).astype(np.float32)
    M = np.ones((m, K), np.float32)
    M[0, 3:] = 0.0          # 3 valid
    M[1, 2:] = 0.0          # 2 valid: plain masked mean / midpoint
    M[2, 1:4] = 0.0         # 2 valid, own U last
    M[3, :] = 0.0
    M[3, -1] = 1.0          # 1 valid
    V[4, 1] *= 50.0         # an outlier
    V[~M.astype(bool)] = 1e3  # padded rows carry garbage
    return V, M


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("agg", ROBUST)
def test_aggregators_match_reference(agg, seed):
    V, M = _candidates(seed)
    got = te.AGGREGATORS[agg](torch.tensor(V), torch.tensor(M))
    want = np.asarray(je.AGGREGATORS[agg](jnp.asarray(V), jnp.asarray(M)))
    assert got.shape == want.shape and torch.isfinite(got).all()
    if agg == "trimmed_mean":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_aggregator_registry_matches_reference():
    assert set(te.AGGREGATORS) == set(je.AGGREGATORS)
    assert te.AGGREGATORS["mean"] is None
    for name in te.AGGREGATORS:
        cfg = te.ConsensusConfig(r=1, aggregator=name)
        assert te.resolve_aggregator(cfg) is te.AGGREGATORS[name]
    with pytest.raises(ValueError, match="unknown aggregator"):
        te.resolve_aggregator(te.ConsensusConfig(r=1, aggregator="bogus"))
    # krum_like picks the first candidate on ties, as jnp.argmin does
    V = np.zeros((1, 3, 2, 1), np.float32)
    V[0, 0], V[0, 2] = 1.0, -1.0
    M = np.ones((1, 3), np.float32)
    np.testing.assert_array_equal(
        te.AGGREGATORS["krum_like"](torch.tensor(V), torch.tensor(M)).numpy(),
        np.asarray(je.AGGREGATORS["krum_like"](jnp.asarray(V),
                                               jnp.asarray(M))))


def test_register_aggregator_runs_in_every_executor():
    first = lambda V, M: V[..., 0, :, :]  # noqa: E731
    te.register_aggregator("first_candidate", first)
    try:
        g = tg.ring(4)
        _, st = _stats(4)
        cfg = te.ConsensusConfig(r=1, iters=3, aggregator="first_candidate")
        for fit in (te.fit_dense, te.fit_colored,
                    lambda s, g, c: te.fit_async(
                        s, g, c, tn.constant_tape(3, g, 2))):
            state, diags = fit(st, g, cfg)
            assert torch.isfinite(state.U).all()
            assert torch.isfinite(diags["objective"]).all()
    finally:
        del te.AGGREGATORS["first_candidate"]


def test_apply_attack_and_audit_match_reference():
    V, M = _candidates(3)
    rng = np.random.default_rng(4)
    m, K, L, r = V.shape
    code = rng.integers(0, 5, (m, K)).astype(np.int32)
    noise = rng.standard_normal(V.shape).astype(np.float32)
    replay = np.ones((L, r), np.float32)
    offset = rng.standard_normal((L, r)).astype(np.float32)
    got = tx.apply_attack(torch.tensor(V), torch.tensor(code)[..., None, None],
                          torch.tensor(noise), torch.tensor(replay),
                          torch.tensor(offset))
    want = jx.apply_attack(jnp.asarray(V), jnp.asarray(code)[..., None, None],
                           jnp.asarray(noise), jnp.asarray(replay),
                           jnp.asarray(offset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for agg in ROBUST:
        center_t = te.AGGREGATORS[agg](torch.tensor(V), torch.tensor(M))
        center = center_t.numpy()
        got = tx.aggregator_audit(torch.tensor(V), torch.tensor(M), center_t)
        want = jx.aggregator_audit(jnp.asarray(V), jnp.asarray(M),
                                   jnp.asarray(center))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[4, 1] == 1.0 and got[:, -1].sum() == 0.0
    # a clean federation audits to an exact zero
    same = np.broadcast_to(V[:, :1], V.shape).copy()
    assert tx.aggregator_audit(torch.tensor(same), torch.tensor(M),
                               torch.tensor(same[:, 0])).sum() == 0.0


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_delivery_table_matches_reference(graph):
    gt, gj = _graphs(graph)
    for a, b in zip(tx.delivery_table(gt), jx.delivery_table(gj)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the tape gather: one plain and one adversary tick
# --------------------------------------------------------------------------


def _gather_pair(graph, adv, agg):
    """Both packages' DenseTapeGather views at tick 5 of a lossy tape (with
    an adversary row where asked), over a ring buffer of random publishes."""
    gt, gj = _graphs(graph)
    m, E, L, r, depth, k = gt.m, gt.n_edges, 8, 2, 4, 5
    rng = np.random.default_rng(len(graph) + 10 * adv)
    hist = rng.standard_normal((depth, m, L, r)).astype(np.float32)
    U = rng.standard_normal((m, L, r)).astype(np.float32)
    U0 = np.ones((m, L, r), np.float32)
    offset = rng.standard_normal((L, r)).astype(np.float32)
    age = rng.integers(1, depth + 1, (2, E))
    code = np.asarray([1, 0, 2, 3, 4, 0][:m], np.int64)
    noise = rng.standard_normal((m, L, r)).astype(np.float32)
    member = np.ones(m, np.float32)
    member[1] = 0.0
    cfg_kw = dict(r=r, aggregator=agg)
    ex_t = tx.DenseExchange(gt, torch.float32, te.AGGREGATORS[agg],
                            device="cpu")
    ex_j = jx.DenseExchange(gj, jnp.float32, je.AGGREGATORS[agg])
    tau_t = torch.tensor(2.0) + ex_t.deg
    tau_j = 2.0 + ex_j.deg
    gt_ = tx.DenseTapeGather(ex_t, gt, te.ConsensusConfig(**cfg_kw), depth,
                             adv, torch.tensor(U0),
                             torch.tensor(offset) if adv else None, tau_t)
    gj_ = jx.DenseTapeGather(ex_j, gj, je.ConsensusConfig(**cfg_kw), depth,
                             adv, jnp.asarray(U0),
                             jnp.asarray(offset) if adv else None, tau_j)
    if adv:
        ctx_t = tx.DenseTapeCtx(torch.tensor(age), k, torch.tensor(code),
                                torch.tensor(noise), torch.tensor(member))
        ctx_j = jx.DenseTapeCtx(jnp.asarray(age, jnp.int32), jnp.int32(k),
                                jnp.asarray(code, jnp.int32),
                                jnp.asarray(noise), jnp.asarray(member))
    else:
        ctx_t = tx.DenseTapeCtx(torch.tensor(age), k)
        ctx_j = jx.DenseTapeCtx(jnp.asarray(age, jnp.int32), jnp.int32(k))
    return (gt_(torch.tensor(hist), torch.tensor(U), ctx_t),
            gj_(jnp.asarray(hist), jnp.asarray(U), ctx_j))


@pytest.mark.parametrize("agg", ["mean", "trimmed_mean"])
@pytest.mark.parametrize("adv", [False, True], ids=["plain", "adversary"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_dense_tape_gather_matches_reference(graph, adv, agg):
    got, want = _gather_pair(graph, adv, agg)
    for a, b in zip(got[:3], want[:3]):       # view0, view1, slot1
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if adv:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    else:
        assert got[3] is None and want[3] is None
    vt, vj = got[4], want[4]
    for name in ("neigh", "center", "deg_eff", "tau_eff", "table", "mask"):
        a, b = getattr(vt, name), getattr(vj, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# fit_async against the reference (r = 1)
# --------------------------------------------------------------------------


def _fit_tapes(gt, gj):
    """The channel tape and the sign-flip + churn adversary tape of the
    parity fits, sampled once in the port (the reference samples the same
    arrays, test_*_matches_reference above)."""
    base = tn.ChannelModel(delay="geometric", scale=2.0, drop=0.1,
                           straggler_prob=0.2, seed=1).sample(gt, ITERS)
    adv = tn.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                            churn=((3, 2, 7),), seed=0).sample(
        gt, ITERS, L=L_FIT, r=1, base=base)
    return {"channel": base, "adversary": adv}


CASES = {
    "channel_live": ("channel", False, "mean"),
    "channel_aged": ("channel", True, "mean"),
    "adversary_mean": ("adversary", True, "mean"),
    "adversary_trimmed_mean": ("adversary", True, "trimmed_mean"),
    "adversary_coordinate_median": ("adversary", True, "coordinate_median"),
}


@pytest.fixture(scope="module")
def parity_runs():
    """Each case's reference and port fits on paper_fig2a, run once."""
    gt, gj = _graphs("paper_fig2a")
    sj, st = _stats(gt.m, seed=3)
    H_te, _ = _data(gt.m, N=7, seed=4)
    tapes = _fit_tapes(gt, gj)
    out = {}
    for name, (tape, aged, agg) in CASES.items():
        kw = dict(r=1, iters=ITERS, tau=2.0, zeta=1.0, aggregator=agg)
        jt = tapes[tape]
        if tape == "adversary":
            jt = jn.AdversaryTape(*jt)
        else:
            jt = jn.EventTape(*jt)
        out[name] = (te.fit_async(st, gt, te.ConsensusConfig(**kw),
                                  tapes[tape], aged_duals=aged),
                     je.fit_async(sj, gj, je.ConsensusConfig(**kw), jt,
                                  aged_duals=aged))
    return out, H_te


@pytest.mark.parametrize("case", list(CASES))
def test_fit_async_matches_reference(parity_runs, case):
    runs, H_te = parity_runs
    (st_t, d_t), (st_j, d_j) = runs[case]
    assert set(d_t) == set(d_j) == ASYNC_KEYS
    np.testing.assert_array_equal(d_t["tape_cursor"].numpy(),
                                  np.asarray(d_j["tape_cursor"]))
    for key in ("objective", "lagrangian"):
        np.testing.assert_allclose(d_t[key].numpy(), np.asarray(d_j[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(d_t["consensus"].numpy(),
                               np.asarray(d_j["consensus"]), rtol=1e-3)
    np.testing.assert_allclose((st_t.U @ st_t.A).numpy(),
                               np.asarray(st_j.U @ st_j.A),
                               rtol=1e-4, atol=1e-4)
    pred_t = td.dmtl_elm_predict(st_t.U, st_t.A, torch.tensor(H_te))
    pred_j = jd.dmtl_elm_predict(st_j.U, st_j.A, jnp.asarray(H_te))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               rtol=1e-4, atol=1e-4)


def test_krum_like_async_is_finite_with_every_key():
    gt, gj = _graphs("paper_fig2a")
    _, st = _stats(gt.m, seed=3)
    tape = _fit_tapes(gt, gj)["adversary"]
    cfg = te.ConsensusConfig(r=1, iters=ITERS, aggregator="krum_like",
                             telemetry=True)
    state, diags = te.fit_async(st, gt, cfg, tape, aged_duals=True)
    assert torch.isfinite(state.U).all() and torch.isfinite(state.lam).all()
    assert set(diags) == ASYNC_KEYS | set(te.TELEMETRY_KEYS) | {
        "comm_floats"}
    assert all(torch.isfinite(v.double()).all() for v in diags.values())


def test_sign_flip_audit_and_delivery_counters():
    """One sign-flipping agent: on a degree-3 graph the robust reduce's
    audit flags its views, and on the clean tape it flags none.  On a ring
    the audit cannot flag one attacker: of the two neighbor candidates the
    median distance is their mean, which the attacker's distance never
    exceeds tenfold.  Every tick's deliveries add up to 2E."""
    _, st = _stats(8, seed=0)
    cfg = te.ConsensusConfig(r=2, iters=12, tau=2.0, zeta=1.0,
                             telemetry=True)
    for g, flags in ((tg.hypercube(3), True), (tg.ring(8), False)):
        tape = tn.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                                 seed=0).sample(g, cfg.iters, L=L_FIT,
                                                r=cfg.r)
        clean = tn.zero_adversary_tape(tn.zero_delay_tape(cfg.iters, g),
                                       L_FIT, cfg.r)
        for agg in ROBUST:
            cfg_a = dataclasses.replace(cfg, aggregator=agg)
            state, adiag = te.fit_async(st, g, cfg_a, tape)
            assert torch.isfinite(state.U).all(), agg
            assert (adiag["agg_rejected"].sum() > 0) == flags, agg
            _, cdiag = te.fit_async(st, g, cfg_a, clean)
            assert cdiag["agg_rejected"].sum() == 0, agg
            total = (adiag["msgs_delivered"] + adiag["msgs_stale"]
                     + adiag["msgs_dropped"])
            assert torch.equal(total, torch.full_like(total,
                                                      2.0 * g.n_edges))


# --------------------------------------------------------------------------
# the port's own identities, bit for bit on CPU tensors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("aged", [False, True], ids=["live_duals",
                                                     "aged_duals"])
def test_zero_delay_tape_is_bitwise_fit_dense(aged):
    g = tg.paper_fig2a()
    _, st = _stats(g.m)
    cfg = te.ConsensusConfig(r=2, iters=20, tau=2.0, zeta=1.0)
    got = te.fit_async(st, g, cfg, tn.zero_delay_tape(cfg.iters, g),
                       aged_duals=aged)
    _same_run(got, te.fit_dense(st, g, cfg), keys=te.DIAG_KEYS)
    assert set(got[1]) == ASYNC_KEYS
    np.testing.assert_array_equal(got[1]["tape_cursor"].numpy(),
                                  np.arange(cfg.iters))


@pytest.mark.parametrize("aged", [False, True], ids=["live_duals",
                                                     "aged_duals"])
def test_zero_attack_adversary_tape_is_bitwise_its_base(aged):
    g = tg.paper_fig2a()
    _, st = _stats(g.m)
    cfg = te.ConsensusConfig(r=2, iters=15, tau=2.0, zeta=1.0,
                             telemetry=True)
    base = tn.ChannelModel(delay="geometric", scale=1.0, drop=0.2,
                           straggler_prob=0.1, seed=3).sample(g, cfg.iters)
    want = te.fit_async(st, g, cfg, base, aged_duals=aged)
    for tape in (tn.zero_adversary_tape(base, L=L_FIT, r=cfg.r),
                 tn.AdversaryModel().sample(g, cfg.iters, L=L_FIT, r=cfg.r,
                                            base=base)):
        got = te.fit_async(st, g, cfg, tape, aged_duals=aged)
        assert set(got[1]) == set(want[1])
        _same_run(got, want)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_constant_tape_is_bitwise_stale_jacobian_sweep(graph, k):
    g, _ = _graphs(graph)
    _, st = _stats(g.m)
    cfg = te.ConsensusConfig(r=2, iters=15, tau=2.0, zeta=1.0)
    got = te.fit_async(st, g, cfg, tn.constant_tape(cfg.iters, g, k))
    want = te.fit_colored(st, g, cfg, staleness=k,
                          schedule=te.jacobian_schedule(g.m))
    _same_run(got, want, keys=te.DIAG_KEYS)


def test_all_dropped_channel_is_bitwise_the_frozen_sweep():
    g = tg.paper_fig2a()
    _, st = _stats(g.m)
    cfg = te.ConsensusConfig(r=2, iters=12, tau=2.0, zeta=1.0)
    got = te.fit_async(st, g, cfg, tn.ChannelModel(drop=1.0).sample(
        g, cfg.iters))
    want = te.fit_colored(st, g, cfg, staleness=cfg.iters,
                          schedule=te.jacobian_schedule(g.m))
    _same_run(got, want, keys=te.DIAG_KEYS)
    assert not torch.allclose(got[0].U, te.fit_dense(st, g, cfg)[0].U)


def test_departed_agent_and_whole_run_straggler_stay_at_the_start():
    g = tg.ring(5)
    _, st = _stats(5)
    cfg = te.ConsensusConfig(r=2, iters=10, tau=2.0, zeta=1.0)
    gone = tn.AdversaryModel(churn=((2, 0, -1),)).sample(g, cfg.iters,
                                                         L=L_FIT, r=2)
    state, diags = te.fit_async(st, g, cfg, gone)
    assert torch.equal(state.U[2], torch.ones_like(state.U[2]))
    assert not torch.equal(state.U[0], torch.ones_like(state.U[0]))
    assert torch.isfinite(diags["objective"]).all()
    tape = tn.zero_delay_tape(cfg.iters, g)
    active = tape.active.copy()
    active[:, 2] = 0.0
    state, _ = te.fit_async(st, g, cfg, tn.EventTape(tape.age, active))
    assert torch.equal(state.U[2], torch.ones_like(state.U[2]))
    assert torch.equal(state.A[2], torch.ones_like(state.A[2]))
    assert not torch.equal(state.U[0], torch.ones_like(state.U[0]))
    # a leave-and-rejoin agent warm-starts and moves, robust reduce too
    back = tn.AdversaryModel(churn=((2, 0, 6),)).sample(g, cfg.iters,
                                                        L=L_FIT, r=2)
    for agg in ("mean", "coordinate_median"):
        state, _ = te.fit_async(
            st, g, dataclasses.replace(cfg, aggregator=agg), back)
        assert not torch.equal(state.U[2], torch.ones_like(state.U[2]))
        assert torch.isfinite(state.U).all()


def test_checkpointed_async_resume_is_bitwise(tmp_path):
    """An aged-duals fit on an adversary tape, checkpointed at tick 4 and
    resumed, gives the uninterrupted fit bit for bit; a tape that does not
    fit the run is refused before the stats pass."""
    g = tg.paper_fig2a()
    H, T = (torch.tensor(x) for x in _data(g.m, seed=5))
    cfg = te.ConsensusConfig(r=2, iters=ITERS, tau=2.0, zeta=1.0,
                             aggregator="coordinate_median")
    base = tn.ChannelModel(delay="geometric", scale=1.0, drop=0.2,
                           seed=2).sample(g, ITERS)
    tape = tn.AdversaryModel(n_byzantine=1, churn=((2, 3, 7),),
                             seed=1).sample(g, ITERS, L=L_FIT, r=2,
                                            base=base)
    kw = dict(executor="async", tape=tape, aged_duals=True)
    want = td.fit(H, T, g, cfg, **kw)
    # the run stopped after its first segment, as a preempted fit leaves it
    runner = te.make_runner(te.sufficient_stats(H, T), g, cfg, **kw)
    state, diags = runner.run_segment(runner.init_state(), 4)
    tck.save_run_checkpoint(tmp_path, state, diags,
                            metadata={"executor": "async", "iters": ITERS})
    got = td.fit(H, T, g, cfg, checkpoint_dir=tmp_path, checkpoint_every=4,
                 resume=True, **kw)
    _same_run(got, want)
    assert tck.latest_step(tmp_path) == ITERS
    state, _, meta = tck.load_run_checkpoint(tmp_path, runner.init_state())
    assert meta["metadata"]["executor"] == "async"
    assert state.k == ITERS and state.lam_hist.shape[0] == tape.depth
    with pytest.raises(ValueError, match="ticks"):
        td.fit(H, T, g, dataclasses.replace(cfg, iters=5), **kw)


def test_fit_async_telemetry_and_trace(tmp_path):
    from repro_torch.obs.counters import modeled_floats_per_iter

    g = tg.ring(5)
    H, T = (torch.tensor(x) for x in _data(5, seed=6))
    cfg = te.ConsensusConfig(r=2, iters=8, tau=2.0, zeta=1.0)
    ch = tn.ChannelModel(delay="geometric", scale=1.0, drop=0.3, seed=2)
    st, diags = td.fit(H, T, g, cfg, executor="async", channel=ch,
                       telemetry=True, trace_dir=tmp_path)
    plain = td.fit(H, T, g, cfg, executor="async", tape=ch.sample(g, 8))
    _same_run((st, {k: diags[k] for k in plain[1]}), plain)
    tape = ch.sample(g, 8)
    fresh = (tape.age == 1).sum(axis=(1, 2))
    np.testing.assert_array_equal(diags["msgs_delivered"].numpy(), fresh)
    np.testing.assert_array_equal(diags["msgs_stale"].numpy(),
                                  2 * g.n_edges - fresh)
    assert (diags["msgs_dropped"] == 0).all()
    assert (diags["agg_rejected"] == 0).all()
    assert (diags["comm_floats"] == modeled_floats_per_iter(
        "async", L=L_FIT, r=2, n_edges=g.n_edges)).all()
    assert (tmp_path / "trace.json").exists()
    assert (tmp_path / "report.json").exists()


# --------------------------------------------------------------------------
# checkpoints cross between the packages
# --------------------------------------------------------------------------


def test_async_checkpoints_cross_between_the_packages(tmp_path):
    """An aged-duals async checkpoint written by each package loads in the
    other, leaf for leaf."""
    gt, gj = _graphs("paper_fig2a")
    H, T = _data(gt.m, seed=7)
    cfg = dict(r=1, iters=6, tau=2.0, zeta=1.0)
    tape = tn.ChannelModel(delay="geometric", scale=1.5, drop=0.2,
                           seed=4).sample(gt, 6)
    adv = tn.AdversaryModel(n_byzantine=1, churn=((1, 2, 4),), seed=3
                            ).sample(gt, 6, L=L_FIT, r=1, base=tape)
    jtape = jn.AdversaryTape(*adv)
    td.fit(torch.tensor(H), torch.tensor(T), gt, te.ConsensusConfig(**cfg),
           executor="async", tape=adv, aged_duals=True,
           checkpoint_dir=tmp_path / "t", checkpoint_every=3)
    jd.fit(jnp.asarray(H), jnp.asarray(T), gj, je.ConsensusConfig(**cfg),
           executor="async", tape=jtape, aged_duals=True,
           checkpoint_dir=tmp_path / "j", checkpoint_every=3)
    assert tck.read_meta(tmp_path / "t")["keys"] == \
        jck.read_meta(tmp_path / "j")["keys"]
    tmpl_t = te.make_runner(
        te.sufficient_stats(torch.tensor(H), torch.tensor(T)), gt,
        te.ConsensusConfig(**cfg), executor="async", tape=adv,
        aged_duals=True).init_state()
    tmpl_j = je.make_runner(
        je.sufficient_stats(jnp.asarray(H), jnp.asarray(T)), gj,
        je.ConsensusConfig(**cfg), executor="async", tape=jtape,
        aged_duals=True).init_state()
    for writer in "tj":
        st_t, d_t, _ = tck.load_run_checkpoint(tmp_path / writer, tmpl_t)
        st_j, d_j, _ = jck.load_run_checkpoint(tmp_path / writer, tmpl_j)
        assert st_t.k == int(st_j.k) == 6
        for name in ("U", "A", "lam", "hist", "lam_hist"):
            np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                          np.asarray(getattr(st_j, name)),
                                          err_msg=f"{writer} {name}")
        assert set(d_t) == set(d_j)
        for key in d_j:
            np.testing.assert_array_equal(d_t[key].numpy(),
                                          np.asarray(d_j[key]))


def test_remap_membership_carries_the_aged_duals_ring():
    gt, gj = _graphs("ring")
    _, st = _stats(gt.m, seed=8)
    runner = te.make_runner(st, gt, te.ConsensusConfig(r=2, iters=5),
                            executor="async",
                            tape=tn.constant_tape(5, gt, 3), aged_duals=True)
    state, _ = runner.run()
    jstate = je.RunState(*(jnp.asarray(x.numpy()) if torch.is_tensor(x)
                           else jnp.asarray(x, jnp.int32) for x in state))
    for new, jnew in ((tg.ring(6), jg.ring(6)), (tg.ring(8), jg.ring(8)),
                      (tg.star(4), jg.star(4))):
        got = tck.remap_membership(state, gt, new)
        want = jck.remap_membership(jstate, gj, jnew)
        for name in ("U", "A", "lam", "hist", "lam_hist"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
