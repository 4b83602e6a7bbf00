"""Privacy configuration for the federated Trainer.

The port of ``repro/privacy/config.py``: the same frozen dataclass, field
for field, with ``validate()``, so a bundle's ``meta["privacy"]`` written by
the port loads in the reference's ``load_bundle``. The default is the
identity (no mechanism active): a Trainer run with the default config is
bit-identical to one without the privacy stack.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

SECURE_AGG_MODES = ("protocol", "pairwise")
DP_GRANULARITIES = ("client", "node")


@dataclass(frozen=True)
class PrivacyConfig:
    """Knobs for DP client updates, secure aggregation and pack noise; the
    meaning of each field is documented on the reference's class."""

    noise_multiplier: float = 0.0
    clip: float = math.inf
    secure_agg: bool = False
    secure_agg_mode: str = "protocol"
    quant_bits: int = 32
    quant_range: float = 32.0
    secure_agg_threshold: Optional[int] = None
    mask_scale: float = 1.0
    pack_noise_multiplier: float = 0.0
    delta: float = 1e-5
    dp_granularity: str = "client"

    @property
    def secure_agg_protocol(self) -> bool:
        """The real (field-masking) protocol is the active secure-agg mode."""
        return self.secure_agg and self.secure_agg_mode == "protocol"

    @property
    def dp_enabled(self) -> bool:
        """The update-DP transform (clip and/or noise) is active."""
        return self.noise_multiplier > 0.0 or math.isfinite(self.clip)

    @property
    def enabled(self) -> bool:
        """Any privacy mechanism is active (False == identity config)."""
        return self.dp_enabled or self.secure_agg or self.pack_noise_multiplier > 0.0

    def validate(self) -> None:
        if self.noise_multiplier < 0:
            raise ValueError(f"noise_multiplier must be >= 0, got {self.noise_multiplier}")
        if self.pack_noise_multiplier < 0:
            raise ValueError(
                f"pack_noise_multiplier must be >= 0, got {self.pack_noise_multiplier}"
            )
        if self.clip <= 0:
            raise ValueError(f"clip must be > 0 (use inf to disable), got {self.clip}")
        if self.mask_scale <= 0:
            raise ValueError(f"mask_scale must be > 0, got {self.mask_scale}")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.noise_multiplier > 0 and not math.isfinite(self.clip):
            raise ValueError(
                "noise_multiplier > 0 requires a finite clip norm: Gaussian "
                "noise is calibrated to the clip (sensitivity) bound"
            )
        if self.secure_agg_mode not in SECURE_AGG_MODES:
            raise ValueError(
                f"secure_agg_mode must be one of {SECURE_AGG_MODES}, "
                f"got {self.secure_agg_mode!r}"
            )
        if not (8 <= self.quant_bits <= 40):
            raise ValueError(
                f"quant_bits must be in [8, 40] (field capacity), got {self.quant_bits}"
            )
        if not (math.isfinite(self.quant_range) and self.quant_range > 0):
            raise ValueError(
                f"quant_range must be finite and > 0, got {self.quant_range}"
            )
        if self.secure_agg_threshold is not None and self.secure_agg_threshold < 1:
            raise ValueError(
                f"secure_agg_threshold must be >= 1, got {self.secure_agg_threshold}"
            )
        if self.dp_granularity not in DP_GRANULARITIES:
            raise ValueError(
                f"dp_granularity must be one of {DP_GRANULARITIES}, "
                f"got {self.dp_granularity!r}"
            )
