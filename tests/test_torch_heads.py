"""Port parity: ``core/heads.py`` and the backbone route
(``repro_torch/backbone.py``, the port of
``examples/decentralized_mtl_backbone.py``).

The reference's backbone weights carry over with
``convert.model_from_numpy``, the hidden layer (W, b) and the tokens are
numpy arrays fed to both packages, and the port runs on CPU tensors (the
kernels' plain versions).  The pipeline at a small size (backbone-12m,
L = 256, ring(4), r = 1, 2 PCG iterations): pooled features within 1e-4,
statistics and ADMM diagnostics within 1e-3, relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_sharded_worlds as worlds  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elm as jelm  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import heads as jh  # noqa: E402
from repro.core.graph import ring as jring  # noqa: E402
from repro.data.pipeline import stream_sufficient_stats as j_stream  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import init_model as j_init  # noqa: E402
from repro_torch import backbone, convert  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import heads as th  # noqa: E402
from repro_torch.core.mesh import spawn  # noqa: E402
from repro_torch.data.pipeline import stream_sufficient_stats  # noqa: E402

M, N_BATCHES, BATCH, SEQ, L = 4, 2, 8, 24, 256


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _token_batches(seed, n_batches=N_BATCHES, n=BATCH):
    """The backbone example's tasks drawn with numpy: (tokens (m, n, SEQ),
    one-hot labels (m, n, C))."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        labels = rng.integers(0, backbone.N_CLASSES, (M, n))
        center = 16 * labels + 3 * (np.arange(M)[:, None] % 4)
        tokens = (center[..., None] + rng.integers(0, 8, (M, n, SEQ))) % 64
        out.append((tokens, np.eye(backbone.N_CLASSES,
                                   dtype=np.float32)[labels]))
    return out


@pytest.fixture(scope="module")
def both():
    """The backbone route through both packages on the same inputs."""
    tcfg = backbone.backbone_config()
    jcfg = JModelConfig(**dataclasses.asdict(tcfg))
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = convert.model_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(7)
    W = (rng.standard_normal((tcfg.d_model, L)) / tcfg.d_model ** 0.5
         ).astype(np.float32)
    b = rng.standard_normal(L).astype(np.float32)
    jfmap = jelm.ELMFeatureMap(W=jnp.asarray(W), b=jnp.asarray(b))
    tfmap = convert.feature_map_from_numpy(W, b, device="cpu")
    batches = _token_batches(1)

    jfeats = [np.asarray(jh.pooled_features(jp, jcfg, jnp.asarray(t)))
              for t, _ in batches]
    jstats = j_stream(((jnp.asarray(f), jnp.asarray(y))
                       for f, (_, y) in zip(jfeats, batches)),
                      producer="fused", feature_map=jfmap)
    jcfg_admm = je.ConsensusConfig(**dataclasses.asdict(
        backbone.admm_config(r=1, iters=2)))
    jstate, jdiag = je.fit_dense(jstats, jring(M), jcfg_admm)

    tbatches = [(torch.tensor(t), torch.tensor(y)) for t, y in batches]
    tfeats = [f for f, _ in backbone.agent_batches(tp, tcfg, tbatches)]
    tstats = stream_sufficient_stats(
        backbone.agent_batches(tp, tcfg, tbatches), producer="fused",
        feature_map=tfmap)
    cfg_admm = backbone.admm_config(r=1, iters=2)
    tstate, tdiag = backbone.fit(tstats, cfg_admm)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jfmap=jfmap,
                tfmap=tfmap, jfeats=jfeats, tfeats=tfeats, jstats=jstats,
                tstats=tstats, jcfg_admm=jcfg_admm, cfg_admm=cfg_admm,
                jstate=jstate, jdiag=jdiag, tstate=tstate, tdiag=tdiag)


def test_backbone_features_match(both):
    for got, want in zip(both["tfeats"], both["jfeats"]):
        assert got.shape == (M, BATCH, 256) and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-4


def test_backbone_stats_and_fit_match(both):
    for leaf in ("G", "R", "n", "t2"):
        assert _rel(getattr(both["tstats"], leaf),
                    getattr(both["jstats"], leaf)) <= 1e-3, leaf
    assert float(both["tstats"].n[0]) == N_BATCHES * BATCH
    for key in ("objective", "lagrangian", "consensus"):
        assert _rel(both["tdiag"][key], both["jdiag"][key]) <= 1e-3, key
    UA = both["tstate"].U @ both["tstate"].A
    jUA = np.einsum("mlr,mrd->mld", both["jstate"].U, both["jstate"].A)
    assert _rel(UA, jUA) <= 1e-3


def test_evaluation_and_heads_match(both):
    """Held-out accuracies from the same fits; ``fit_head_local`` and
    ``predict_all`` against the reference's."""
    tokens, labels = _token_batches(99, n_batches=1, n=16)[0]
    acc = backbone.evaluate(both["tp"], both["tcfg"], both["tfmap"],
                            both["tstate"], both["tstats"], both["cfg_admm"],
                            torch.tensor(tokens), torch.tensor(labels))
    H = both["jfmap"](jh.pooled_features(both["jp"], both["jcfg"],
                                         jnp.asarray(tokens)))
    jlocal = jh.fit_head_local(both["jstats"], both["jcfg_admm"])
    jhead = jh.MultiTaskELMHead(U=both["jstate"].U, A=both["jstate"].A)
    truth = labels.argmax(-1)
    want = {
        "dmtl": float(np.mean(np.asarray(jhead.predict_all(H)).argmax(-1)
                              == truth)),
        "local": float(np.mean(np.asarray(jlocal.predict_all(H)).argmax(-1)
                               == truth)),
    }
    assert acc == pytest.approx(want, abs=1 / (M * 16) + 1e-9)
    tlocal = th.fit_head_local(both["tstats"], both["cfg_admm"])
    assert _rel(tlocal.U, jlocal.U) <= 1e-3
    np.testing.assert_array_equal(tlocal.A.numpy(), np.asarray(jlocal.A))
    tH = torch.tensor(np.asarray(H))
    assert _rel(tlocal.predict_all(tH), jlocal.predict_all(H)) <= 1e-3
    assert _rel(tlocal.predict(tH[2], 2), jlocal.predict(H[2], 2)) <= 1e-3


def test_pooled_features_with_mask(both):
    tokens = _token_batches(5, n_batches=1, n=3)[0][0]
    mask = np.random.default_rng(5).random(tokens.shape) < 0.6
    mask[0, 0] = False                      # an all-masked row pools to 0
    want = jh.pooled_features(both["jp"], both["jcfg"], jnp.asarray(tokens),
                              jnp.asarray(mask))
    got = th.pooled_features(both["tp"], both["tcfg"], torch.tensor(tokens),
                             torch.tensor(mask))
    assert _rel(got, want) <= 1e-4
    assert float(got[0, 0].abs().max()) == 0.0
    unmasked = th.pooled_features(both["tp"], both["tcfg"],
                                  torch.tensor(tokens))
    torch.testing.assert_close(
        unmasked, th.pooled_features(both["tp"], both["tcfg"],
                                     torch.tensor(tokens),
                                     torch.ones(tokens.shape, dtype=bool)),
        rtol=1e-6, atol=1e-6)


def test_fit_head_is_the_multi_gpu_slice(both):
    """``fit_head`` runs one agent per rank (a gloo world of M ranks on the
    CPU) and gives every rank the fit of ``engine.fit_dense`` on ring(M)."""
    st = both["tstats"]
    args = ({k: getattr(st, k).numpy() for k in ("G", "R", "n", "t2")},
            both["cfg_admm"])
    heads = spawn(worlds.fit_head_world, M, args=args, timeout_s=300)
    for U, A, diags in heads:
        for got, want in ((U, both["tstate"].U), (A, both["tstate"].A),
                          (diags["objective"], both["tdiag"]["objective"])):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


def test_task_batches_follow_the_example():
    gen = torch.Generator().manual_seed(0)
    tokens, labels = backbone.make_task_batch(gen, 2, n=50, seq=12)
    assert tokens.shape == (50, 12) and labels.shape == (50, 4)
    band = (tokens - 16 * labels.argmax(-1)[:, None] - 6) % 64
    assert int(band.min()) >= 0 and int(band.max()) < 8
    batches = list(backbone.token_batches(gen, 3, n=5, seq=7, m=4))
    assert len(batches) == 3 and batches[0][0].shape == (4, 5, 7)
    assert (batches[0][1].sum(-1) == 1).all()
    again = backbone.make_task_batch(torch.Generator().manual_seed(0), 2,
                                     n=50, seq=12)
    assert torch.equal(again[0], tokens) and torch.equal(again[1], labels)

