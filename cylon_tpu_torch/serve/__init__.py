"""cylon_tpu_torch.serve: multi-tenant query serving over one context.

A copy of ``cylon_tpu/serve/``: a bounded-queue admission controller and
one scheduler thread that turn overload into a classified, recoverable
condition (`Code.ResourceExhausted` / `Code.Unavailable` with retry-after
hints, never a hang or an OOM), per-tenant deadline, memory and failure
budgets, and the durable journal as a result cache.
"""
from .cache import cache_bytes, contents, maybe_gc, served_from_journal
from .service import (OPS, QueryService, TenantBudget, Ticket,
                      default_deadline_s, hbm_budget_bytes, queue_cap,
                      register_op, tenant_quarantine_after,
                      tenant_quarantine_s, tenant_share)

__all__ = [
    "QueryService", "TenantBudget", "Ticket", "OPS", "register_op",
    "queue_cap", "tenant_share", "hbm_budget_bytes", "default_deadline_s",
    "tenant_quarantine_after", "tenant_quarantine_s",
    "served_from_journal", "contents", "cache_bytes", "maybe_gc",
]
