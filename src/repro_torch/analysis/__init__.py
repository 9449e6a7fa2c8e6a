"""Analytic cost model."""

from repro_torch.analysis.flops import analytic_cost

__all__ = ["analytic_cost"]
