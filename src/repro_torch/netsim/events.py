"""Event tapes: the precompiled, fixed-shape schedule of an async run.

The network simulator never branches on randomness inside the ADMM loop.
A :class:`ChannelModel` (``repro_torch.netsim.channels``) is sampled ONCE on
the host into an :class:`EventTape` — dense arrays indexed by tick — and the
simulated run is a loop over the tape rows whose rows are uploaded to the
device once per segment, so the executor never syncs per tick and is
bit-reproducible for a given tape.  The same numpy code as the reference's
``repro.netsim.events``: a tape sampled by either package is the other's
array for array.

Tape semantics (per tick ``k`` = one global ADMM round):

``age[k, dir, j]``
    Staleness, in rounds, of the freshest *delivered* message on directed
    edge ``j`` (direction 0: ``e -> s``, direction 1: ``s -> e`` for edge
    ``(s, e)``).  ``age = a`` means the receiver computes its tick-``k``
    update from the sender's subspace as it stood ``a`` publishes ago:
    the ``U`` published at the end of tick ``k - a``.  ``a = 1`` is the
    freshest a synchronous-round simulation allows (the previous round's
    publish) and reproduces the Jacobian sweep; ``a = k + 1`` means
    nothing has ever been delivered and the receiver still holds the
    initial ``U^0`` — the drop-fallback view.  The unit is chosen so the
    tape age IS ``fit_colored``'s ``staleness``: a constant-``k`` tape
    reproduces ``fit_colored(staleness=k)`` exactly.

``active[k, t]``
    1.0 iff agent ``t`` completes its local update at tick ``k``; a
    straggling agent (0.0) republishes its unchanged state instead.

Invariants (established by the samplers, asserted by :func:`validate_tape`,
fuzzed in the tests):

* ``1 <= age[k] <= k + 1`` — a message cannot be fresher than last round's
  publish, nor older than "never delivered";
* ``age[k + 1] <= age[k] + 1`` — the held view never gets older by more
  than the one round that just elapsed (dropped/late messages fall back to
  the PREVIOUS delivered view, they never rewind further or zero out);
* ``active`` is a {0, 1} mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.graph import Graph


class EventTape(NamedTuple):
    """A fixed-shape async schedule: one row per tick (see module docs)."""

    age: np.ndarray     # (iters, 2, E) int32, in [1, k + 1] at tick k
    active: np.ndarray  # (iters, m) float32, {0, 1}

    @property
    def iters(self) -> int:
        return self.age.shape[0]

    @property
    def n_edges(self) -> int:
        return self.age.shape[2]

    @property
    def depth(self) -> int:
        """Ring-buffer depth the executor needs: the oldest view any tick
        serves (>= 1; the zero-delay tape needs only the previous publish)."""
        return max(1, int(self.age.max())) if self.age.size else 1


def validate_tape(
    tape: EventTape, g: Graph, iters: int | None = None, *, start: int = 0,
) -> None:
    """Assert the tape invariants against ``g`` (raises ValueError).

    ``start`` is the absolute tick of row 0 — a resumed run re-validates
    the suffix it is about to replay by passing the sliced tape with
    ``start=k``, which keeps the ``age <= tick + 1`` bound anchored to the
    true tick (the cross-boundary age-step invariant is the prefix run's
    responsibility; it was checked before the checkpoint was written).
    """
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    age, active = np.asarray(tape.age), np.asarray(tape.active)
    if age.ndim != 3 or age.shape[1] != 2 or age.shape[2] != g.n_edges:
        raise ValueError(
            f"age must be (iters, 2, E={g.n_edges}), got {age.shape}"
        )
    n_iters = age.shape[0]
    if iters is not None and n_iters != iters:
        raise ValueError(f"tape has {n_iters} ticks but the run wants {iters}")
    if active.shape != (n_iters, g.m):
        raise ValueError(
            f"active must be ({n_iters}, m={g.m}), got {active.shape}"
        )
    if n_iters == 0:
        return
    if age.min() < 1:
        raise ValueError(f"age must be >= 1 (got min {age.min()})")
    ticks = np.arange(start, start + n_iters)[:, None, None]
    bad = age > ticks + 1
    if bad.any():
        k = start + int(np.argwhere(bad)[0][0])
        raise ValueError(
            f"age at tick {k} exceeds k + 1: no message can predate U^0"
        )
    if (np.diff(age, axis=0) > 1).any():
        raise ValueError(
            "age increased by more than 1 in one tick: a held view can only "
            "age by the round that elapsed (drop fallback never rewinds)"
        )
    if not np.isin(active, (0.0, 1.0)).all():
        raise ValueError("active must be a {0, 1} mask")
    # Duck-typed adversary extension (repro_torch.netsim.adversary.AdversaryTape):
    # plain EventTapes carry none of these fields and skip the block.
    attack = getattr(tape, "attack", None)
    if attack is not None:
        attack = np.asarray(attack)
        member = np.asarray(tape.member)
        noise = np.asarray(tape.noise)
        offset = np.asarray(tape.offset)
        if attack.shape != (n_iters, g.m):
            raise ValueError(
                f"attack must be ({n_iters}, m={g.m}), got {attack.shape}"
            )
        if attack.min() < 0 or attack.max() > 4:
            raise ValueError(
                f"attack codes must be in [0, 4], got "
                f"[{attack.min()}, {attack.max()}]"
            )
        if member.shape != (n_iters, g.m):
            raise ValueError(
                f"member must be ({n_iters}, m={g.m}), got {member.shape}"
            )
        if not np.isin(member, (0.0, 1.0)).all():
            raise ValueError("member must be a {0, 1} mask")
        if noise.shape[:2] != (n_iters, g.m) or noise.ndim != 4:
            raise ValueError(
                f"noise must be ({n_iters}, m={g.m}, L, r), got {noise.shape}"
            )
        if offset.shape != noise.shape[2:]:
            raise ValueError(
                f"offset must match noise payload shape {noise.shape[2:]}, "
                f"got {offset.shape}"
            )
        if (attack * (member == 0.0)).any():
            raise ValueError(
                "an absent agent cannot attack: attack must be 0 wherever "
                "member is 0"
            )
        if (active * (member == 0.0)).any():
            raise ValueError(
                "an absent agent cannot compute: active must be 0 wherever "
                "member is 0"
            )
        # leave-with-inflight: a delivery must never land from a
        # non-member.  The held publish tick is k - age[k]; a strict
        # increase marks a fresh delivery, which requires the sender to be
        # a member at BOTH the publish tick and the arrival tick (churn
        # flushes in-flight traffic; it is never replayed on rejoin).
        # Publish ticks before a resumed slice (start > 0) are the prefix
        # run's responsibility, as is row 0's across-boundary freshness.
        src = np.asarray([s for s, _ in g.edges])
        dst = np.asarray([e for _, e in g.edges])
        sender = np.stack([dst, src])  # dir 0: e -> s, dir 1: s -> e
        held = ticks - age             # (n_iters, 2, E); -1 = U^0
        fresh = np.zeros(held.shape, bool)
        fresh[1:] = held[1:] > held[:-1]
        if start == 0:
            fresh[0] = held[0] >= 0
        mem = member > 0.0
        sender_b = np.broadcast_to(sender[None], held.shape)
        k_idx = np.broadcast_to(
            np.arange(n_iters)[:, None, None], held.shape
        )
        arr_ok = mem[k_idx, sender_b]
        pub_rel = held - start
        pub_ok = ~(pub_rel >= 0) | mem[np.clip(pub_rel, 0, None), sender_b]
        bad = fresh & ~(arr_ok & pub_ok)
        if bad.any():
            k, d, j = np.argwhere(bad)[0]
            raise ValueError(
                f"delivery from a non-member at tick {start + k} on edge "
                f"{j} (dir {d}): in-flight messages must be masked when "
                f"the sender leaves, not replayed (sender "
                f"{sender[d, j]}, publish tick {held[k, d, j]})"
            )


def zero_delay_tape(iters: int, g: Graph) -> EventTape:
    """The lossless synchronous tape: every message one round old, every
    agent active — ``fit_async`` on it is bitwise ``fit_dense`` (parity
    oracle 1)."""
    return EventTape(
        age=np.ones((iters, 2, g.n_edges), np.int32),
        active=np.ones((iters, g.m), np.float32),
    )


def constant_tape(iters: int, g: Graph, k: int) -> EventTape:
    """Every message exactly ``k`` rounds stale (clipped to the pre-history
    ``U^0`` while tick + 1 < k), every agent active — ``fit_async`` on it
    reproduces ``fit_colored(staleness=k)`` (parity oracle 2)."""
    if k < 1:
        raise ValueError(f"constant tape staleness must be >= 1, got {k}")
    age = np.minimum(k, np.arange(iters, dtype=np.int32)[:, None, None] + 1)
    return EventTape(
        age=np.broadcast_to(age, (iters, 2, g.n_edges)).astype(np.int32),
        active=np.ones((iters, g.m), np.float32),
    )


def ages_from_arrivals(arrival: np.ndarray) -> np.ndarray:
    """Reduce per-publish arrival ticks to the per-tick delivered age.

    ``arrival[q, ...]`` is the tick at which the message PUBLISHED at the
    end of tick ``q`` is delivered (``np.inf`` = dropped; deliveries may
    arrive out of order).  The receiver always computes from the freshest
    delivered publish: ``age[k] = k - max{q : arrival[q] <= k}``, falling
    back to ``k + 1`` (the initial view) while nothing has arrived.
    """
    iters = arrival.shape[0]
    age = np.empty(arrival.shape, np.int32)
    q_idx = np.arange(iters).reshape((iters,) + (1,) * (arrival.ndim - 1))
    for k in range(iters):
        delivered = np.where(arrival[: k + 1] <= k, q_idx[: k + 1], -1)
        age[k] = k - delivered.max(axis=0)
    return age
