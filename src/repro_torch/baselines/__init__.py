"""MTL baselines the paper compares against (Table I / Fig. 5):

  Local ELM — repro_torch.core.elm (per-task, no sharing)
  MTFL      — convex multi-task feature learning [Argyriou et al., 2008]
  GO-MTL    — grouping & overlap via sparse latent bases [Kumar & Daume, 2012]
  DGSP/DNSP — distributed gradient/Newton subspace pursuit
              [Wang, Kolar & Srebro, 2016], master-slave structure

Small batched ``torch.linalg`` products and solves over the task axis; they
run where their inputs are.
"""

from repro_torch.baselines.mtfl import mtfl_fit, mtfl_predict
from repro_torch.baselines.gomtl import gomtl_fit, gomtl_predict
from repro_torch.baselines.subspace_pursuit import dgsp_fit, dnsp_fit, sp_predict

__all__ = ["dgsp_fit", "dnsp_fit", "gomtl_fit", "gomtl_predict", "mtfl_fit",
           "mtfl_predict", "sp_predict"]
