"""64-bit tensor audit: the port's counterpart of the JAX package's
"narrow mode traces 64-bit free" check (``tests/test_precision.py``,
which searches a jaxpr for ``[iuf]64[...]`` arrays).

The port traces nothing, so :func:`dtype_audit` runs a callable under a
``TorchDispatchMode`` and looks at every aten op's outputs instead: each
output of ``int64``, ``uint64`` or ``float64`` with at least one
dimension is a 64-bit site (0-d scalars are free, as the reference's
regex leaves weak-typed scalar literals out).  A site is named by the
innermost ``cylon_tpu_torch`` frame that issued the op
(``module:function``, the package prefix dropped), the aten op and the
dtype; it carries its op count and output bytes, against the bytes of
every op output of the run.

    result, audit = dtype_audit(fn, *args)
    audit.site_keys()  # {("ops.keys:lexsort_indices",
                       #   "aten.arange.default", "int64"), ...}
    audit.wide_bytes, audit.total_bytes, audit.share

Views count as outputs (a 64-bit view of 32-bit data is a 64-bit array
to the consumer), so bytes are output bytes, not allocations.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

WIDE_DTYPES = (torch.int64, torch.uint64, torch.float64)
_PACKAGE = "cylon_tpu_torch"

SiteKey = Tuple[str, str, str]  # (module:function, aten op, dtype)


@dataclass
class Audit:
    """What one :func:`dtype_audit` run saw: per site ``[ops, bytes]``,
    and the output bytes of every op."""

    sites: Dict[SiteKey, list] = field(default_factory=dict)
    total_bytes: int = 0

    @property
    def wide_bytes(self) -> int:
        return sum(b for _, b in self.sites.values())

    @property
    def share(self) -> float:
        """64-bit output bytes over all output bytes."""
        return self.wide_bytes / self.total_bytes if self.total_bytes else 0.0

    def site_keys(self) -> Set[SiteKey]:
        return set(self.sites)

    def table(self):
        """[(module:function, op, dtype, ops, bytes)], most bytes first."""
        return sorted(((*k, n, b) for k, (n, b) in self.sites.items()),
                      key=lambda r: (-r[4], r[:3]))


def _caller() -> str:
    """The innermost frame of the package outside this module, as
    ``module:function`` without the package prefix; "<outside>" when the
    op came from elsewhere (the caller's own code)."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if (mod == _PACKAGE or mod.startswith(_PACKAGE + ".")) \
                and mod != __name__:
            short = mod[len(_PACKAGE) + 1:] or _PACKAGE
            return f"{short}:{f.f_code.co_name}"
        f = f.f_back
    return "<outside>"


class _AuditMode(TorchDispatchMode):
    def __init__(self, audit: Audit):
        super().__init__()
        self.audit = audit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            nbytes = t.numel() * t.element_size()
            self.audit.total_bytes += nbytes
            if t.dtype in WIDE_DTYPES and t.dim() >= 1:
                key = (_caller(), str(func), str(t.dtype).replace("torch.",
                                                                  ""))
                rec = self.audit.sites.setdefault(key, [0, 0])
                rec[0] += 1
                rec[1] += nbytes
        return out


def dtype_audit(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), Audit)``: the call's result and its 64-bit
    sites."""
    audit = Audit()
    with _AuditMode(audit):
        result = fn(*args, **kwargs)
    return result, audit
