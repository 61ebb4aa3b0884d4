"""Per-tenant wire-byte quotas over the engine's exact ledger.

A copy of `repro.serve.admission.quotas` on `repro_torch.obs`.  Every
`JobResult` already carries the exact gossip bytes the job moved
(`repro_torch.comm.CommLedger` per-slot send counters × bytes-per-send),
so a tenant budget needs no estimation: the loop charges `TenantLedger`
at retirement with the measured bytes and consults it at submission.

Two enforcement modes:

* ``"reject"`` (default): a tenant at/over budget gets a
  `QuotaExceeded` at `submit()` — the job never enters the queue.
* ``"deprioritize"``: the submit is accepted but the entry's effective
  priority is clamped to `deprioritized_priority` (below every default
  class), so over-budget tenants only run when nobody else wants the
  accelerator — and they can never preempt.

Accounting is deliberately at *retirement*, not admission: the charge
is the job's true cost, and an in-flight job of a tenant that just
crossed its budget is never evicted for billing reasons (quota is an
admission policy, not a correctness constraint).

Charges publish to the metrics registry (`serve_tenant_wire_bytes`
gauge per tenant, `serve_quota_rejections_total` counter) so a
dashboard sees budget burn next to queue depth.
"""
from __future__ import annotations

from ... import obs

#: Effective priority of a deprioritized entry — below every
#: DEFAULT_CLASSES level, so over-budget tenants run last.
DEPRIORITIZED_PRIORITY = -100

QUOTA_MODES = ("reject", "deprioritize")


class QuotaExceeded(RuntimeError):
    """Raised by `submit()` in "reject" mode for a tenant at/over its
    wire-byte budget."""


class TenantLedger:
    """Budget table + spent counters for the admission loop.

    budgets:        {tenant: wire-byte budget}.  Tenants absent from
                    the table fall back to `default_budget`.
    default_budget: budget for unlisted tenants (None = unmetered).
    mode:           "reject" | "deprioritize" (see module docstring).
    """

    def __init__(self, budgets: dict | None = None,
                 default_budget: int | None = None,
                 mode: str = "reject"):
        if mode not in QUOTA_MODES:
            raise ValueError(f"unknown quota mode {mode!r}; expected "
                             f"one of {QUOTA_MODES}")
        self.budgets = dict(budgets or {})
        for tenant, b in self.budgets.items():
            if not int(b) >= 0:
                raise ValueError(
                    f"tenant {tenant!r} budget must be >= 0 (got {b})")
        self.default_budget = None if default_budget is None \
            else int(default_budget)
        self.mode = mode
        self._spent: dict[str, int] = {}

    # -- accounting ---------------------------------------------------------

    def budget(self, tenant: str) -> int | None:
        """The tenant's wire-byte budget (None = unmetered)."""
        return self.budgets.get(tenant, self.default_budget)

    def spent(self, tenant: str) -> int:
        """Exact ledger bytes charged to the tenant so far."""
        return self._spent.get(tenant, 0)

    def remaining(self, tenant: str) -> int | None:
        """Budget minus spent, clamped at 0 (None = unmetered)."""
        b = self.budget(tenant)
        return None if b is None else max(b - self.spent(tenant), 0)

    def charge(self, tenant: str, wire_bytes: int) -> None:
        """Bill retired-job bytes to the tenant (exact, from the
        bucket ledger's per-slot send counters)."""
        self._spent[tenant] = self.spent(tenant) + int(wire_bytes)
        obs.registry().gauge(
            "serve_tenant_wire_bytes",
            "exact ledger bytes charged to the tenant so far"
        ).labels(tenant=tenant).set(float(self._spent[tenant]))

    # -- admission policy ---------------------------------------------------

    def over_budget(self, tenant: str) -> bool:
        rem = self.remaining(tenant)
        return rem is not None and rem <= 0

    def admit(self, tenant: str, priority: int) -> int:
        """Admission verdict for one submit: the entry's effective
        priority.  Under budget (or unmetered) passes `priority`
        through; over budget either raises `QuotaExceeded` ("reject")
        or clamps to `DEPRIORITIZED_PRIORITY` ("deprioritize")."""
        if not self.over_budget(tenant):
            return int(priority)
        if self.mode == "reject":
            obs.registry().counter(
                "serve_quota_rejections_total",
                "submits rejected because the tenant was over budget"
            ).labels(tenant=tenant).inc()
            raise QuotaExceeded(
                f"tenant {tenant!r} is over its wire-byte budget "
                f"({self.spent(tenant)} spent of {self.budget(tenant)})"
                f" — raise the budget or switch the ledger to "
                f"mode='deprioritize'")
        obs.instant("quota_deprioritize", cat="serve.admission",
                    track="admission", tenant=tenant,
                    spent=self.spent(tenant))
        return min(int(priority), DEPRIORITIZED_PRIORITY)

    # -- persistence (loop checkpoint sidecar) -------------------------------

    def snapshot(self) -> dict:
        return dict(self._spent)

    def restore(self, spent: dict) -> None:
        self._spent = {t: int(v) for t, v in spent.items()}
