"""Roofline analysis: the traced step's three terms (``analysis``, over the
counts of ``counter``) and the engine super-tick's (``obs/roofline.py``)."""

from repro_torch.obs.roofline import (
    model_flops_per_supertick,
    supertick_report,
    supertick_roofline,
)
from repro_torch.roofline.analysis import analyze_traced, collective_bytes, roofline_terms

__all__ = [
    "analyze_traced",
    "collective_bytes",
    "model_flops_per_supertick",
    "roofline_terms",
    "supertick_report",
    "supertick_roofline",
]
