"""Roofline terms and analytic counts for the H100 (the port of
``src/repro/roofline``)."""

from .analysis import HW, model_flops, roofline_terms
from .op_cost import OpCost, analyze, charge

__all__ = ["HW", "model_flops", "roofline_terms", "OpCost", "analyze",
           "charge"]
