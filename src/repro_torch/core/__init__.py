"""The paper's algorithms on sufficient statistics: ELM primitives, solvers,
consensus graphs, the neighbor exchange, the dense and colored consensus
executors with their segmented ``Runner`` (the checkpointed runs of
``repro_torch.checkpoint``), and the MTL-ELM / DMTL-ELM / FO-DMTL-ELM entry
points."""

from repro_torch.core.dmtl_elm import (
    DMTLELMConfig,
    DMTLELMState,
    dmtl_elm_fit,
    dmtl_elm_predict,
    fit,
)
from repro_torch.core.elm import (
    ELMFeatureMap,
    elm_fit,
    elm_objective,
    elm_predict,
    make_feature_map,
)
from repro_torch.core.engine import (
    ConsensusConfig,
    Runner,
    RunState,
    SufficientStats,
    fit_colored,
    fit_dense,
    jacobian_schedule,
    make_runner,
    produce_stats,
    sufficient_stats,
    sufficient_stats_fused,
)
from repro_torch.core.fo_dmtl_elm import fo_dmtl_elm_fit
from repro_torch.core.graph import (
    Graph,
    chain,
    complete,
    erdos,
    expander,
    hypercube,
    paper_fig2a,
    ring,
    star,
)
from repro_torch.core.mtl_elm import (
    MTLELMConfig,
    mtl_elm_fit,
    mtl_elm_fit_from_stats,
    mtl_elm_predict,
)

__all__ = [
    "ConsensusConfig", "DMTLELMConfig", "DMTLELMState", "ELMFeatureMap",
    "Graph", "MTLELMConfig", "RunState", "Runner", "SufficientStats",
    "chain", "complete",
    "dmtl_elm_fit", "dmtl_elm_predict", "elm_fit", "elm_objective",
    "elm_predict", "erdos", "expander", "fit", "fit_colored", "fit_dense",
    "fo_dmtl_elm_fit", "hypercube", "jacobian_schedule", "make_feature_map",
    "make_runner", "mtl_elm_fit",
    "mtl_elm_fit_from_stats", "mtl_elm_predict", "paper_fig2a",
    "produce_stats", "ring", "star", "sufficient_stats",
    "sufficient_stats_fused",
]
