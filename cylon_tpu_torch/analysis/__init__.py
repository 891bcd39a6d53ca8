"""cylint on the port — the repo's static analyzer over
``cylon_tpu_torch/``, the counterpart of ``cylon_tpu/analysis/``.

The invariants this package checks are ones no compiler sees:

- every process of a group must issue the same collectives, so a branch
  on a rank-local device value must not decide whether one runs (CY101);
- every ``CYLON_TPU_*`` knob is read through the registry in
  ``cylon_tpu_torch.config`` (CY102), and a cached callable that reads a
  trace-scope knob keys on it (CY103; the plan fingerprint, CY108);
- collectives never sit inside a retry wrapper unless the policy is the
  context's ``collective_retry_policy`` (CY104); exceptions keep their
  ``Status`` classification (CY105);
- the fleet's control paths: elastic recovery paths reach an epoch guard
  (CY106), the serve and router control paths never block on the device
  (CY107, CY110), placement and journal locks are never held across an
  RPC or an fsync (CY111), and across the package locks are taken in one
  order (CY113), nothing blocks under a lock (CY114) and no attribute is
  written from two threads without a common lock (CY115);
- persisted state is version-checked (CY116) and checksummed (CY117)
  before it is decoded.

Level 2 (``budgets.py``) counts the collectives each distributed entry
point issues at a small canonical grid and pins them in committed
goldens (CY201/CY202); the lock-order golden (``locks.py``) pins the
edges the runtime recorder observes (CY203/CY204).

Run ``python -m cylon_tpu_torch.analysis cylon_tpu_torch/``.  Suppress
per line with ``# cylint: disable=CY1xx -- <justification>``; the
justification text is mandatory (CY001).
"""
from .astlint import Finding, RULES, scan_paths  # noqa: F401
