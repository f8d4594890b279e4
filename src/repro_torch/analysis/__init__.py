"""Static plan and kernel verification (no execution), the twin of the JAX
package's ``repro.analysis``.

The paper's correctness guarantee -- receptive-field-aware partitioning keeps
distributed inference bit-identical to local inference -- is enforced
dynamically by the ``run_plan`` losslessness tests.  This package proves the
same invariants *by analysis*, in milliseconds per plan:

* :mod:`~repro_torch.analysis.plan_check` -- row coverage, receptive-field
  exactness, halo algebra/reach, message legality, auto-reduce monotonicity,
  scheme-stage legality, head divisibility (pure integer arithmetic);
* :mod:`~repro_torch.analysis.dag_check` -- acyclicity of dependency +
  resource-FIFO edges (static deadlock detection), transfer endpoint
  locality, orphan transfers, template-vs-scalar-builder duration audits;
* :mod:`~repro_torch.analysis.kernel_check` -- a shape-only probe of the
  fused halo-conv kernel's wrapper on ``meta`` tensors (support-predicate
  agreement and output shapes) for every geometry a plan deploys;
* :mod:`~repro_torch.analysis.keying_lint` -- AST enforcement of the
  config-fingerprint partition (every ``ReplanConfig`` field keys the plan
  store or carries a justified exclusion) and ``PlanStore.get``'s row vetoes.

``PlanStore.get`` runs :func:`check_plan` on deserialized rows before
serving them; ``optimize_plan(verify=True)`` and ``run_plan(verify=True)``
gate on it.
"""
from .dag_check import check_dag, check_template
from .findings import AnalysisError, Finding, Report
from .keying_lint import check_keying
from .kernel_check import check_kernel_geometry, check_plan_kernels
from .plan_check import check_plan

__all__ = [
    "AnalysisError",
    "Finding",
    "Report",
    "check_dag",
    "check_keying",
    "check_kernel_geometry",
    "check_plan",
    "check_plan_kernels",
    "check_template",
]
