"""Static checks on a traced step. Port of ``repro/analysis``, so far its
dtype-policy check (``analysis.dtype``)."""
from repro_torch.analysis.dtype import (
    BF16_COMPUTE_POLICY,
    F32_POLICY,
    CheckResult,
    DtypePolicy,
    check_dtype_policy,
    record_float_dtypes,
    state_leaves,
)

__all__ = ["BF16_COMPUTE_POLICY", "F32_POLICY", "CheckResult", "DtypePolicy",
           "check_dtype_policy", "record_float_dtypes", "state_leaves"]
