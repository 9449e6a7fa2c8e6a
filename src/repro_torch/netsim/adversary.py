"""Adversary models: Byzantine attacks + membership churn as tape extensions.

An :class:`AdversaryModel` describes WHO misbehaves and HOW, sampled ONCE on
the host (the same deterministic ``np.random.default_rng(seed)`` idiom as
``channels.ChannelModel``) into an :class:`AdversaryTape` — a fixed-shape
extension of :class:`~repro_torch.netsim.events.EventTape` the async
executor replays tick by tick.  Nothing stochastic happens inside the
loop; re-running a tape is bit-reproducible.  The draws are the
reference's (``repro.netsim.adversary``), in its order, so a tape matches
its tape bit for bit.

Attack semantics (per tick ``k``, applied to the *published* views other
agents receive — the sender's own state is never corrupted, matching the
Byzantine model where an adversary lies on the wire):

``attack[k, t] = 0``  honest publish.
``attack[k, t] = 1``  ``sign_flip``: neighbors receive ``-U_t`` (and the
                      negated dual when ``aged_duals`` ships duals).
``attack[k, t] = 2``  ``gaussian_noise``: neighbors receive
                      ``U_t + noise[k, t]`` (scale pre-applied host-side).
``attack[k, t] = 3``  ``stale_replay``: neighbors receive the INITIAL
                      ``U^0`` publish, forever (a replayed dual is the
                      zero initial dual).
``attack[k, t] = 4``  ``colluding_offset``: neighbors receive
                      ``U_t + offset`` where ``offset`` is ONE shared
                      per-run direction — colluding attackers push the
                      consensus the same way, the case coordinate-wise
                      defenses find hardest.

Membership semantics:

``member[k, t]``      1.0 iff agent ``t`` is part of the federation at tick
                      ``k``.  A departed agent freezes (like a straggler),
                      every edge with a departed endpoint leaves all
                      reductions (degree masking) and its dual freezes; a
                      (re)joining agent warm-starts from the aggregate of
                      its live neighbors' views.  An absent agent never
                      attacks (the sampler enforces ``attack * member``).

The zero-adversary oracle: ``AdversaryModel(n_byzantine=0)`` (no churn)
sampled over a base channel tape replays bitwise-identically to the base
tape — asserted in tests, the seam this module is pinned by.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.netsim.events import EventTape, validate_tape, zero_delay_tape

ATTACK_KINDS = {
    "sign_flip": 1,
    "gaussian_noise": 2,
    "stale_replay": 3,
    "colluding_offset": 4,
}


class AdversaryTape(NamedTuple):
    """EventTape + per-tick attack codes, noise, and membership (module docs).

    Duck-typed superset of :class:`EventTape`: everything that consumes
    ``age``/``active`` (the executor, ``validate_tape``, frontier helpers)
    works unchanged; the adversary-aware paths key on the extra fields.
    """

    age: np.ndarray      # (iters, 2, E) int32, EventTape semantics
    active: np.ndarray   # (iters, m) float32 {0, 1}
    attack: np.ndarray   # (iters, m) int32, codes 0..4 (ATTACK_KINDS)
    noise: np.ndarray    # (iters, m, L, r) float32, scale pre-applied
    offset: np.ndarray   # (L, r) float32, the shared colluding direction
    member: np.ndarray   # (iters, m) float32 {0, 1}

    @property
    def iters(self) -> int:
        return self.age.shape[0]

    @property
    def n_edges(self) -> int:
        return self.age.shape[2]

    @property
    def depth(self) -> int:
        return max(1, int(self.age.max())) if self.age.size else 1


def zero_adversary_tape(
    base: EventTape, L: int, r: int
) -> AdversaryTape:
    """Wrap a plain EventTape with no attacks and full membership — the
    bitwise pass-through extension (parity oracle for the tier-B executor
    path)."""
    iters, m = base.active.shape
    return AdversaryTape(
        age=np.asarray(base.age),
        active=np.asarray(base.active),
        attack=np.zeros((iters, m), np.int32),
        noise=np.zeros((iters, m, L, r), np.float32),
        offset=np.zeros((L, r), np.float32),
        member=np.ones((iters, m), np.float32),
    )


def _mask_nonmember_arrivals(
    age: np.ndarray, member: np.ndarray, g: Graph
) -> np.ndarray:
    """Flush a departed sender's in-flight traffic from the age table.

    The base channel tape is sampled before membership, so its arrival
    schedule can deliver a message published before a leave AFTER the
    sender departed — and the receiver would then replay that view once
    the sender rejoins.  Real churn flushes in-flight traffic: a delivery
    only lands if the sender is a member at BOTH the publish tick and the
    arrival tick; a masked delivery falls back to the last validly held
    view (``U^0`` at worst), the same fallback rule as a drop.  Forward
    pass over the reduced age table; preserves all EventTape invariants.
    """
    iters = age.shape[0]
    if iters == 0:
        return age
    src = np.asarray([s for s, _ in g.edges])
    dst = np.asarray([e for _, e in g.edges])
    sender = np.stack([dst, src])  # dir 0: e -> s, dir 1: s -> e
    mem = np.asarray(member) > 0.0
    out = np.empty_like(age)
    held = np.full((2, g.n_edges), -1, np.int64)  # valid held publish tick
    raw_prev = np.full((2, g.n_edges), -1, np.int64)
    for k in range(iters):
        raw = k - age[k].astype(np.int64)  # freshest delivered publish
        fresh = raw > raw_prev             # a delivery landed this tick
        ok = (
            fresh
            & mem[k][sender]                        # member at arrival
            & mem[np.clip(raw, 0, None), sender]    # member at publish
        )
        held = np.where(ok, raw, held)
        raw_prev = raw
        out[k] = (k - held).astype(age.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class AdversaryModel:
    """Who misbehaves and how (see module docs).

    ``n_byzantine`` agents are drawn once per run; each attacks at a given
    tick with probability ``attack_rate``, picking uniformly among
    ``kinds``.  ``churn`` schedules explicit membership events as
    ``(agent, leave_tick, rejoin_tick)`` triples (``rejoin_tick = -1`` =
    permanent departure); ``leave_prob`` additionally drives a random
    leave/rejoin busy-walk with mean absence ``mean_absence`` rounds —
    the same geometric-walk idiom as ``ChannelModel``'s stragglers.
    """

    n_byzantine: int = 0
    attack_rate: float = 1.0
    kinds: tuple = tuple(ATTACK_KINDS)
    noise_scale: float = 1.0
    offset_scale: float = 1.0
    churn: tuple = ()              # ((agent, leave_tick, rejoin_tick), ...)
    leave_prob: float = 0.0
    mean_absence: float = 5.0
    seed: int = 0

    def __post_init__(self):
        if self.n_byzantine < 0:
            raise ValueError(
                f"n_byzantine must be >= 0, got {self.n_byzantine}"
            )
        if not 0.0 <= self.attack_rate <= 1.0:
            raise ValueError(
                f"attack_rate must be in [0, 1], got {self.attack_rate}"
            )
        for kind in self.kinds:
            if kind not in ATTACK_KINDS:
                raise ValueError(
                    f"unknown attack kind {kind!r}; expected a subset of "
                    f"{sorted(ATTACK_KINDS)}"
                )
        if self.n_byzantine > 0 and not self.kinds:
            raise ValueError("n_byzantine > 0 needs a non-empty kinds tuple")
        if self.noise_scale < 0 or self.offset_scale < 0:
            raise ValueError("noise_scale/offset_scale must be >= 0")
        for ev in self.churn:
            agent, leave, rejoin = ev
            if leave < 0:
                raise ValueError(f"churn leave_tick must be >= 0, got {ev}")
            if rejoin != -1 and rejoin <= leave:
                raise ValueError(
                    f"churn rejoin_tick must be > leave_tick or -1, got {ev}"
                )
        if not 0.0 <= self.leave_prob <= 1.0:
            raise ValueError(
                f"leave_prob must be in [0, 1], got {self.leave_prob}"
            )
        if self.mean_absence < 1.0:
            raise ValueError(
                f"mean_absence must be >= 1 round, got {self.mean_absence}"
            )

    def sample(
        self,
        g: Graph,
        iters: int,
        L: int,
        r: int,
        base: EventTape | None = None,
    ) -> AdversaryTape:
        """Roll the adversary out over ``g`` into an AdversaryTape.

        ``base`` supplies the channel behavior (delays/drops/stragglers);
        ``None`` means the lossless synchronous channel
        (``zero_delay_tape``).  ``L``/``r`` size the noise/offset payloads
        to the run's subspace shape.
        """
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        if base is None:
            base = zero_delay_tape(iters, g)
        if np.asarray(base.age).shape[0] != iters:
            raise ValueError(
                f"base tape has {np.asarray(base.age).shape[0]} ticks but "
                f"the run wants {iters}"
            )
        m = g.m
        if self.n_byzantine > m:
            raise ValueError(
                f"n_byzantine={self.n_byzantine} exceeds m={m} agents"
            )
        rng = np.random.default_rng(self.seed)

        # --- attack plan: who, when, how ---------------------------------
        attack = np.zeros((iters, m), np.int32)
        if self.n_byzantine > 0 and iters > 0:
            byz = rng.choice(m, self.n_byzantine, replace=False)
            fire = rng.uniform(size=(iters, self.n_byzantine)) < (
                self.attack_rate
            )
            codes = np.asarray([ATTACK_KINDS[kk] for kk in self.kinds])
            pick = rng.integers(0, len(codes), size=(iters, self.n_byzantine))
            attack[:, byz] = np.where(fire, codes[pick], 0)
        noise = rng.standard_normal((iters, m, L, r)).astype(np.float32)
        noise *= np.float32(self.noise_scale)
        offset = rng.standard_normal((L, r)).astype(np.float32)
        offset *= np.float32(self.offset_scale)

        # --- membership: scheduled churn + random leave walk -------------
        member = np.ones((iters, m), np.float32)
        for agent, leave, rejoin in self.churn:
            end = iters if rejoin == -1 else min(rejoin, iters)
            member[leave:end, agent] = 0.0
        if self.leave_prob > 0.0 and iters > 0:
            away = np.zeros(m, np.int64)
            for k in range(iters):
                absent = away > 0
                member[k, absent] = 0.0
                away[absent] -= 1
                here = ~absent
                go = here & (rng.uniform(size=m) < self.leave_prob)
                away[go] = rng.geometric(1.0 / self.mean_absence, m)[go]

        # an absent agent neither attacks nor computes
        attack = np.where(member > 0, attack, 0).astype(np.int32)
        active = np.asarray(base.active, np.float32) * member

        # ... nor does its in-flight traffic survive a leave: re-age the
        # channel's arrival schedule so nothing published by or arriving
        # from a non-member is ever delivered (leave-with-inflight fix)
        age = np.asarray(base.age, np.int32)
        if (member == 0.0).any():
            age = _mask_nonmember_arrivals(age, member, g)

        tape = AdversaryTape(
            age=age,
            active=active,
            attack=attack,
            noise=noise,
            offset=offset,
            member=member,
        )
        validate_tape(tape, g, iters)
        return tape
