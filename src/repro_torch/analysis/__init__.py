"""repro_torch.analysis — the paper's closed-form error bounds (a copy of
``repro/analysis/error_bounds.py``), in ``program`` the per-device cost of
a traced sharded step, and in ``hlo`` and ``report`` the dry-run's
collective parser, roofline arithmetic and table."""
from repro_torch.analysis.error_bounds import (
    series_envelope,
    thm3_coefficient_bound,
    thm4_layer1_bound,
    thm35_logit_bound,
)

__all__ = [
    "series_envelope",
    "thm3_coefficient_bound",
    "thm35_logit_bound",
    "thm4_layer1_bound",
]
