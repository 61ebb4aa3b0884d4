"""Near-miss bucket packing: one runner across heterogeneous K.

A copy of `repro.serve.admission.packing`.  A bucket's runner (the
port's counterpart of `repro`'s compiled chunk program) depends on the
chunk length T, the bucket width and everything in the *pack* signature
(shapes, topology, mixing/comm path, M/U loop bounds) — but NOT on the
jobs' round budgets K: each chunk runs per-slot (T,) schedule slices
gathered on the host.  So jobs that differ only in K can share a bucket, and
therefore a runner-cache entry, as long as

* every slot's schedule rows are padded to the bucket's capacity
  ``K_max`` (`batching.pad_schedule`; the padding rows sit past the
  slot's budget and are never consumed), and
* the chunk length T divides every packed job's **remaining** budget,
  so each slot hits its own retirement round exactly at a chunk
  boundary (`pack_chunk_rounds`) — bitwise equality with the solo run
  is preserved per slot because the slot runs exactly its own K_j
  rounds of its own schedule, in T-round slices, which the port's round
  loop makes bit-identical to the single K_j-round run.

A packed slot retires when ``rounds == budget`` (its own K_j), or
earlier via `JobSpec.tol` at any chunk boundary — the bucket keeps
running until its widest tenant is done, freed slots backfilling from
the queue as usual.

`plan_bucket` picks (T, K_max) for a new bucket from the queue entries
that want it; entries whose remaining budget T cannot divide simply
stay queued and get their own bucket once this one drains (the loop
re-plans whenever it opens a bucket), so incompatible K mixes degrade
to today's one-bucket-per-K behavior instead of erroring.
"""
from __future__ import annotations

from ..jobs import pack_signature  # noqa: F401  (re-export: the pack key)


def pack_chunk_rounds(budgets, requested: int) -> int | None:
    """Largest T ≤ `requested` with T ≥ 2 dividing every budget in
    `budgets` — the packed analogue of `batching.chunk_rounds_for`.
    None when no common divisor ≥ 2 exists (the caller falls back to
    an unpacked plan)."""
    budgets = [int(b) for b in budgets]
    if not budgets or min(budgets) < 2:
        return None
    top = max(2, min(int(requested), min(budgets)))
    for t in range(top, 1, -1):
        if all(b % t == 0 for b in budgets):
            return t
    return None


def compatible(remaining: int, T: int, K_max: int, budget: int) -> bool:
    """May a job with `remaining` rounds left (and total budget
    `budget`) join a live bucket running T-round chunks at capacity
    `K_max`?  Needs rounds left, a chunk boundary exactly at its
    retirement round, and schedule rows that fit the capacity."""
    return remaining > 0 and remaining % T == 0 and budget <= K_max


def plan_bucket(entries, requested: int) -> tuple[int, int, list]:
    """Choose (T, K_max, admissible) for a new bucket.

    `entries` are queue entries sharing a bucket key, priority-ordered,
    each exposing `.budget` (total K) and `.remaining` (K minus rounds
    already run — resumes mid-flight).  Tries the widest pack first
    (one T dividing every entry's remaining budget); when the mix has
    no common chunk length, falls back to packing only the entries
    compatible with the *head* entry's plan — the rest stay queued for
    the next bucket.  Always admits at least the head entry."""
    entries = list(entries)
    head = entries[0]
    T = pack_chunk_rounds([e.remaining for e in entries], requested)
    if T is None:
        # no common chunk length: plan around the head entry alone,
        # then pick up whoever happens to fit that plan
        from ..batching import chunk_rounds_for
        T = chunk_rounds_for(head.remaining, requested)
    K_max = max(e.budget for e in entries
                if compatible(e.remaining, T, e.budget, e.budget))
    K_max = max(K_max, head.budget)
    admissible = [e for e in entries
                  if compatible(e.remaining, T, K_max, e.budget)]
    return T, K_max, admissible
