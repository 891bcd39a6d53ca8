"""cylon_tpu_torch.plan — the logical query planner.

The port of ``cylon_tpu/plan/``.  ``Table.plan()`` starts a lazy
:class:`LogicalPlan`; builder methods (``filter``/``project``/
``with_column``/``join``/``groupby``/``sort``/``limit``) append IR nodes;
``execute()`` runs the rule-optimized plan (shuffle elision, column
pruning, scan sharing, the fused join -> aggregate shard body —
``CYLON_TPU_PLAN`` gates the optimizer) and ``explain()`` renders every
decision.  ``col``/``lit`` build the fingerprintable expressions plan
filters and derived columns require.
"""
from .executor import execute, planner_enabled, run_service
from .expr import Expr, col, lit
from .ir import LogicalPlan
from .profile import PlanProfile, profiler_enabled

__all__ = ["LogicalPlan", "Expr", "col", "lit", "execute",
           "planner_enabled", "run_service", "PlanProfile",
           "profiler_enabled"]
