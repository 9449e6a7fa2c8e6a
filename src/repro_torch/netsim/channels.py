"""Channel models: stochastic link/compute behavior sampled into event tapes.

A :class:`ChannelModel` describes a geo-distributed deployment the paper's
synchronous rounds idealize away (cf. Baytas et al. 2016 AMTL; Liu et al.
2017 DMTRL): per-directed-edge random message delays, i.i.d. message drops,
and per-agent compute-time stragglers.  ``sample`` rolls the whole run out
on the host into a fixed-shape :class:`~repro_torch.netsim.events.EventTape`,
so the simulated execution itself (``engine.fit_async``) is deterministic —
resampling the channel is cheap, re-running a tape is reproducible.  The
draws are the reference's (``repro.netsim.channels``), in its order: the
same seed and graph give its tape array for array.

Delay distributions (``delay`` / ``scale``), all in extra rounds on top of
the inherent one-round latency of a synchronous-round simulation:

* ``"deterministic"`` — every message exactly ``round(scale)`` rounds late:
  ``scale = 0`` is the lossless synchronous channel (the ``fit_dense``
  oracle), ``scale = d`` samples exactly ``constant_tape(d + 1)`` (the
  ``fit_colored(staleness=d + 1)`` oracle).
* ``"geometric"``     — memoryless links: extra delay ~ Geometric with mean
  ``scale`` (the Baytas-style bounded-expectation delay).
* ``"heavy_tail"``    — Pareto-like links: extra delay = floor(scale *
  (Z - 1)) with Z ~ Pareto(alpha); rare but enormous stalls, the regime
  where mean-delay intuition fails.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.netsim.events import EventTape, ages_from_arrivals, validate_tape

DELAY_KINDS = ("deterministic", "geometric", "heavy_tail")


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Per-edge delay + drop and per-agent straggler model (see module docs).

    ``drop`` is the i.i.d. probability that a published message never
    arrives; the receiver then keeps computing from the last delivered view
    (never from zeros — at worst the initial ``U^0``).  ``straggler_prob``
    is the per-completed-update probability that the agent stalls, drawing
    a Geometric busy time with mean ``straggler_mean`` rounds during which
    it republishes its unchanged state.
    """

    delay: str = "deterministic"   # DELAY_KINDS
    scale: float = 0.0             # mean extra rounds (exact for deterministic)
    drop: float = 0.0              # i.i.d. message-drop probability
    straggler_prob: float = 0.0    # P(an update is followed by a stall)
    straggler_mean: float = 3.0    # mean stall length, rounds (geometric)
    alpha: float = 1.5             # heavy_tail shape (smaller = heavier)
    seed: int = 0

    def __post_init__(self):
        if self.delay not in DELAY_KINDS:
            raise ValueError(
                f"unknown delay kind {self.delay!r}; expected one of "
                f"{DELAY_KINDS}"
            )
        if self.scale < 0:
            raise ValueError(f"scale must be >= 0, got {self.scale}")
        if not 0.0 <= self.drop <= 1.0:
            raise ValueError(f"drop must be in [0, 1], got {self.drop}")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError(
                f"straggler_prob must be in [0, 1], got {self.straggler_prob}"
            )
        if self.straggler_mean < 1.0:
            raise ValueError(
                f"straggler_mean must be >= 1 round, got {self.straggler_mean}"
            )
        if self.alpha <= 1.0:
            raise ValueError(
                f"alpha must be > 1 (finite-mean Pareto), got {self.alpha}"
            )

    def _extra_delays(self, rng: np.random.Generator, shape) -> np.ndarray:
        if self.delay == "deterministic":
            return np.full(shape, int(round(self.scale)), np.int64)
        if self.scale == 0.0:
            return np.zeros(shape, np.int64)
        if self.delay == "geometric":
            # np geometric counts trials to first success (>= 1); extra
            # delay is failures-before-success so the mean is `scale`
            p = 1.0 / (1.0 + self.scale)
            return rng.geometric(p, shape).astype(np.int64) - 1
        # heavy_tail: floor(scale * (Z - 1)), Z ~ Pareto(alpha) >= 1
        z = 1.0 + rng.pareto(self.alpha, shape)
        return np.floor(self.scale * (z - 1.0)).astype(np.int64)

    def quantiles(self, qs, n: int = 20000, seed: int = 0) -> np.ndarray:
        """Empirical extra-delay quantiles of this channel (host draws)."""
        rng = np.random.default_rng(seed)
        return np.quantile(self._extra_delays(rng, (n,)), qs)

    def sample(self, g: Graph, iters: int) -> EventTape:
        """Roll ``iters`` rounds of this channel on ``g`` into an EventTape.

        Per directed edge and publish tick ``q``: the message published at
        the end of tick ``q`` arrives at ``q + 1 + extra_delay`` unless
        dropped; :func:`ages_from_arrivals` reduces the arrival schedule to
        the freshest-delivered age per tick.  Per agent: a busy-time walk
        turns ``straggler_prob``/``straggler_mean`` into the active mask.
        """
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        rng = np.random.default_rng(self.seed)
        shape = (iters, 2, g.n_edges)
        arrival = (
            np.arange(iters, dtype=np.float64)[:, None, None]
            + 1.0
            + self._extra_delays(rng, shape)
        )
        if self.drop > 0.0:
            arrival = np.where(
                rng.uniform(size=shape) < self.drop, np.inf, arrival
            )
        age = ages_from_arrivals(arrival)

        active = np.ones((iters, g.m), np.float32)
        if self.straggler_prob > 0.0:
            busy = np.zeros(g.m, np.int64)
            for k in range(iters):
                working = busy > 0
                active[k, working] = 0.0
                busy[working] -= 1
                done = ~working
                stall = done & (rng.uniform(size=g.m) < self.straggler_prob)
                busy[stall] = rng.geometric(
                    1.0 / self.straggler_mean, g.m
                )[stall]
        tape = EventTape(age=age, active=active)
        validate_tape(tape, g, iters)
        return tape


TRACE_QUANTILES = (0.5, 0.9, 0.99)

_HEAVY_TAIL_ALPHAS = (1.2, 1.5, 2.0, 2.5, 3.0)


def from_trace(
    path,
    *,
    round_ms: "float | None" = None,
    drop: "float | None" = None,
    straggler_prob: float = 0.0,
    straggler_mean: float = 3.0,
    seed: int = 0,
    n_fit: int = 20000,
) -> ChannelModel:
    """Fit a :class:`ChannelModel` delay distribution to a latency trace.

    ``path`` is a CSV of per-message one-way latencies in milliseconds:
    either a single headerless column or a headered file with a
    ``latency_ms`` column (other columns are ignored).  Non-finite or
    non-positive entries are treated as messages that never arrived and
    estimate the ``drop`` probability (override with ``drop=``).

    The fit discretizes the trace into extra synchronous rounds —
    ``extra = max(0, ceil(latency / round_ms) - 1)`` with ``round_ms``
    defaulting to the trace median, so the median message costs the
    inherent one round — then selects the delay family
    (deterministic | geometric | heavy_tail) and scale whose sampled
    extra-delay quantiles at ``TRACE_QUANTILES`` (50/90/99) best match the
    empirical ones (summed relative error; candidate scales moment-matched
    to the trace mean, heavy-tail ``alpha`` over a small grid).  The
    returned model reproduces the trace's delay *distribution*, not its
    per-message sequence — ``sample`` re-rolls i.i.d. draws from the
    fitted family, which is exactly what the event-tape machinery wants.
    """
    raw = np.genfromtxt(path, delimiter=",", names=True)
    if raw.dtype.names:
        col = (
            "latency_ms" if "latency_ms" in raw.dtype.names
            else raw.dtype.names[0]
        )
        lat = np.atleast_1d(np.asarray(raw[col], np.float64))
    else:
        lat = np.asarray(raw, np.float64).ravel()
    if lat.size == 0:
        raise ValueError(f"empty latency trace: {path}")
    delivered = np.isfinite(lat) & (lat > 0.0)
    est_drop = float(drop if drop is not None else 1.0 - delivered.mean())
    lat = lat[delivered]
    if lat.size == 0:
        raise ValueError(f"no delivered messages in trace: {path}")
    if round_ms is None:
        round_ms = float(np.median(lat))
    if round_ms <= 0:
        raise ValueError(f"round_ms must be > 0, got {round_ms}")
    extra = np.maximum(np.ceil(lat / round_ms) - 1.0, 0.0)
    emp_q = np.quantile(extra, TRACE_QUANTILES)
    mean_extra = float(extra.mean())

    common = dict(
        drop=est_drop, straggler_prob=straggler_prob,
        straggler_mean=straggler_mean, seed=seed,
    )
    candidates = [
        ChannelModel(
            delay="deterministic", scale=float(np.round(mean_extra)),
            **common,
        ),
        ChannelModel(delay="geometric", scale=mean_extra, **common),
    ]
    for alpha in _HEAVY_TAIL_ALPHAS:
        # E[floor(scale * (Z - 1))] <~ scale / (alpha - 1) for Z~Pareto(alpha)
        candidates.append(
            ChannelModel(
                delay="heavy_tail", scale=mean_extra * (alpha - 1.0),
                alpha=alpha, **common,
            )
        )

    def _score(cm: ChannelModel) -> float:
        q = cm.quantiles(TRACE_QUANTILES, n=n_fit, seed=seed)
        return float(np.sum(np.abs(q - emp_q) / np.maximum(emp_q, 1.0)))

    return min(candidates, key=_score)
