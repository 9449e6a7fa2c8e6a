"""The paper's algorithms on sufficient statistics: ELM primitives, solvers,
consensus graphs, the neighbor exchange, the dense and colored consensus
executors with their segmented ``Runner`` (the checkpointed runs of
``repro_torch.checkpoint``), the event-tape async executor of
``repro_torch.netsim`` (``fit_async``), the one-agent-per-rank sharded
executors over a ``torch.distributed`` mesh (``fit_sharded``,
``fit_sharded_graph``, ``core.mesh``), and the MTL-ELM / DMTL-ELM /
FO-DMTL-ELM entry points."""

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
    fit_async,
    fit_colored,
    fit_dense,
    fit_sharded,
    fit_sharded_graph,
    graph_matches_torus,
    jacobian_schedule,
    make_runner,
    produce_stats,
    sufficient_stats,
    sufficient_stats_fused,
)
from repro_torch.core.fo_dmtl_elm import fo_dmtl_elm_fit
from repro_torch.core.graph import (
    EdgeSchedule,
    Graph,
    chain,
    compile_edge_schedule,
    complete,
    erdos,
    expander,
    hypercube,
    paper_fig2a,
    ring,
    star,
)
from repro_torch.core.mesh import Mesh, make_mesh, spawn
from repro_torch.core.mtl_elm import (
    MTLELMConfig,
    mtl_elm_fit,
    mtl_elm_fit_from_stats,
    mtl_elm_predict,
)
from repro_torch.core.sharded_dmtl import (
    dmtl_elm_fit_sharded,
    dmtl_fit_from_stats,
)

__all__ = [
    "ConsensusConfig", "DMTLELMConfig", "DMTLELMState", "ELMFeatureMap",
    "EdgeSchedule", "Graph", "MTLELMConfig", "Mesh", "RunState", "Runner",
    "SufficientStats", "chain", "compile_edge_schedule", "complete",
    "dmtl_elm_fit", "dmtl_elm_fit_sharded", "dmtl_elm_predict",
    "dmtl_fit_from_stats", "elm_fit", "elm_objective",
    "elm_predict", "erdos", "expander", "fit", "fit_async", "fit_colored",
    "fit_dense", "fit_sharded", "fit_sharded_graph", "graph_matches_torus",
    "make_mesh", "spawn",
    "fo_dmtl_elm_fit", "hypercube", "jacobian_schedule", "make_feature_map",
    "make_runner", "mtl_elm_fit",
    "mtl_elm_fit_from_stats", "mtl_elm_predict", "paper_fig2a",
    "produce_stats", "ring", "star", "sufficient_stats",
    "sufficient_stats_fused",
]
