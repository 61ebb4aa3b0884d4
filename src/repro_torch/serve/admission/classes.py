"""Priority / deadline classes for the admission loop.

A copy of `repro.serve.admission.classes` (pure Python).

A `PriorityClass` names a service level: a numeric priority (higher
preempts lower), whether jobs of the class may themselves be preempted,
and an optional relative deadline that turns the queue into
earliest-deadline-first *within* a priority level.

Scheduling contract (see `admission.loop`):

* the queue drains in `admission_key` order — priority first (higher
  wins), then absolute deadline (earlier wins), then submission order;
* a queued entry may **preempt** a running slot only when its priority
  is strictly higher and the victim's class is `preemptible` — equal
  priorities never preempt each other (deadlines order admission, not
  eviction, so a late-deadline job that already holds a slot keeps it);
* preemption happens exclusively at chunk boundaries: the victim's
  carry is lifted out bit-exactly (`BucketState.preempt`) and the job
  re-enters the queue as a resumable entry, so no rounds are ever
  re-run or lost.

`DEFAULT_CLASSES` gives the conventional three-tier service split;
callers can pass their own dict to `AdmissionLoop(classes=...)`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One service level.

    name:        `JobSpec.klass` key.
    priority:    higher preempts lower (strictly).
    preemptible: may a running job of this class be evicted at a chunk
                 boundary by a strictly-higher-priority arrival?
    deadline_s:  default relative deadline applied at submission
                 (None = no deadline; EDF tie-break within priority).
    """
    name: str
    priority: int
    preemptible: bool = True
    deadline_s: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("PriorityClass needs a non-empty name")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive when set "
                f"(got {self.deadline_s})")


#: Conventional three-tier split: realtime preempts and is never
#: preempted, standard is the default, batch soaks up leftover slots.
DEFAULT_CLASSES = {
    "realtime": PriorityClass("realtime", 100, preemptible=False,
                              deadline_s=1.0),
    "standard": PriorityClass("standard", 10),
    "batch": PriorityClass("batch", 0),
}


def resolve_class(classes: dict, name: str) -> PriorityClass:
    """Look a `JobSpec.klass` name up in the loop's class table, with
    an actionable error for typos."""
    try:
        return classes[name]
    except KeyError:
        raise ValueError(
            f"unknown priority class {name!r}; this loop knows "
            f"{sorted(classes)} — pass classes=... to AdmissionLoop "
            f"to define more") from None


def admission_key(priority: int, deadline_abs: float | None,
                  seq: int) -> tuple:
    """Total order the queue drains in: priority desc, deadline asc
    (None sorts last within its priority), submission order asc."""
    return (-int(priority),
            float("inf") if deadline_abs is None else float(deadline_abs),
            int(seq))
