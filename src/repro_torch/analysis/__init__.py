"""Static-analysis subsystem: step, collective and AST invariant checks.
Port of ``repro/analysis``.

Three layers, none of which trains anything:

* ``repro_torch.analysis.trace`` (the reference's ``jaxpr.py``) records one
  step with the scope of every operation (``record_step``) and runs the
  named checks on it (O(1)-in-M tick bodies, the last-stage vocab head, the
  2K-1 stash bound, the flash kernels inside the ticks); the dtype policy
  is ``repro_torch.analysis.dtype``;
* ``repro_torch.analysis.collectives`` (``hlo.py``) records the transport's
  calls and checks their process groups against ``Topology``, and the
  donated step's storages;
* ``repro_torch.analysis.lint``: AST rules over ``src/repro_torch``.

``repro_torch.analysis.runner`` drives all of it over the engine matrix:
``python -m repro_torch.analysis --matrix smoke``. The exports are the
reference's, less its XLA-text parsers (``parse_collectives`` and the
alias parser) and its jaxpr unwrapping (``as_jaxpr``, ``sub_jaxprs``),
which have no torch meaning.
"""
from repro_torch.analysis.collectives import (
    COLLECTIVE_OPS,
    CollectiveInstr,
    CollectiveStats,
    check_async_step_reduction,
    check_collective_axes,
    check_data_reduction,
    check_donation,
    collective_stats,
    declared_groupings,
)
from repro_torch.analysis.dtype import (
    BF16_COMPUTE_POLICY,
    F32_POLICY,
    CheckResult,
    DtypePolicy,
    check_dtype_policy,
    record_float_dtypes,
    state_leaves,
)
from repro_torch.analysis.lint import (
    LintFinding,
    check_repo_lint,
    lint_file,
    lint_source,
    lint_tree,
)
from repro_torch.analysis.trace import (
    check_kernel_in_scan,
    check_no_dot_outside_cond,
    check_pallas_in_scan,
    check_scan_body_constant_in_microbatches,
    check_stash_bound,
    float_dtypes,
    iter_avals,
    iter_eqns,
    leading_dims_of,
    max_float_bytes,
    n_eqns,
    record_step,
    vocab_dot_counts,
)

__all__ = [
    "BF16_COMPUTE_POLICY",
    "CheckResult",
    "DtypePolicy",
    "F32_POLICY",
    "check_dtype_policy",
    "check_kernel_in_scan",
    "check_no_dot_outside_cond",
    "check_pallas_in_scan",
    "check_scan_body_constant_in_microbatches",
    "check_stash_bound",
    "float_dtypes",
    "iter_avals",
    "iter_eqns",
    "leading_dims_of",
    "max_float_bytes",
    "n_eqns",
    "record_float_dtypes",
    "record_step",
    "state_leaves",
    "vocab_dot_counts",
    "COLLECTIVE_OPS",
    "CollectiveInstr",
    "CollectiveStats",
    "check_async_step_reduction",
    "check_collective_axes",
    "check_data_reduction",
    "check_donation",
    "collective_stats",
    "declared_groupings",
    "LintFinding",
    "check_repo_lint",
    "lint_file",
    "lint_source",
    "lint_tree",
]
