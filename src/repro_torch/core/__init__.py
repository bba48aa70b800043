# The paper's primary contribution: Adam with Basis Rotation for
# asynchronous pipeline parallelism (Algorithms 1-2 + stage-aware scheduling).
from repro_torch.core.basis_rotation import basis_rotation_adam
from repro_torch.core.layout import LeafPlan, build_layout
from repro_torch.core.rotation import power_qr, refresh_basis, rotate, unrotate
from repro_torch.core.stage_aware import (
    NEVER,
    StageContext,
    freqs_for_delays,
    stage_aware_freq,
)

__all__ = [
    "basis_rotation_adam",
    "LeafPlan",
    "build_layout",
    "power_qr",
    "refresh_basis",
    "rotate",
    "unrotate",
    "NEVER",
    "StageContext",
    "freqs_for_delays",
    "stage_aware_freq",
]
