"""Event-driven network simulator for decentralized consensus ADMM.

The paper's DMTL-ELM assumes lossless synchronous rounds; this package
models the regime geo-distributed agents face (random per-link delays,
dropped messages, compute stragglers, Byzantine senders, agents that join
and leave) without touching the update math.  The port of the reference's
``repro.netsim``:

* ``channels.ChannelModel`` — per-edge delay distribution (deterministic /
  geometric / heavy-tail), i.i.d. drop probability, per-agent straggler
  model; sampled ONCE on the host with numpy.  ``channels.from_trace`` fits
  the delay family + scale (and drop rate) to a latency-trace CSV.
* ``events.EventTape``     — the sampled run as fixed-shape per-tick arrays
  (message ages, active mask) with validated invariants.
* ``executor.fit_async``   — the async executor: a loop over the tape
  around the unchanged ``engine.agent_update``, stale views served from a
  ring buffer of published subspaces (and optionally duals) on the device.
* ``adversary.AdversaryModel`` — Byzantine attack plans (sign_flip /
  gaussian_noise / stale_replay / colluding_offset on the published views)
  plus join/leave membership churn, sampled into ``AdversaryTape``
  extensions the same executor replays; pairs with the robust
  ``cfg.aggregator`` registry (``engine.AGGREGATORS``).
* ``frontier``             — iters-to-gap bookkeeping.

The tapes are the reference's, array for array, for the same seed and
graph.
"""

from repro_torch.netsim.adversary import (
    ATTACK_KINDS,
    AdversaryModel,
    AdversaryTape,
    zero_adversary_tape,
)
from repro_torch.netsim.channels import (
    DELAY_KINDS,
    TRACE_QUANTILES,
    ChannelModel,
    from_trace,
)
from repro_torch.netsim.events import (
    EventTape,
    ages_from_arrivals,
    constant_tape,
    validate_tape,
    zero_delay_tape,
)
from repro_torch.netsim.executor import fit_async
from repro_torch.netsim.frontier import gap_target, iters_to_target, tape_summary

__all__ = [
    "ATTACK_KINDS", "AdversaryModel", "AdversaryTape", "zero_adversary_tape",
    "DELAY_KINDS", "TRACE_QUANTILES", "ChannelModel", "from_trace",
    "EventTape", "ages_from_arrivals", "constant_tape", "validate_tape",
    "zero_delay_tape",
    "fit_async",
    "gap_target", "iters_to_target", "tape_summary",
]
