"""repro_torch.privacy.attacks — empirical privacy auditing (the port of
``repro.privacy.attacks``): node membership inference against a trained
federated model (mia.py), measuring what a concrete adversary learns
beside the accountant's bound."""
from repro_torch.privacy.attacks.mia import (
    attack_curve,
    node_scores,
    run_membership_inference,
    shadow_attack,
    threshold_attack,
)

__all__ = [
    "attack_curve",
    "node_scores",
    "run_membership_inference",
    "shadow_attack",
    "threshold_attack",
]
