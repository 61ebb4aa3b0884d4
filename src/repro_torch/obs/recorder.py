"""Flight recorder — per-round scalars kept on the device.

Counterpart of `repro.obs.recorder`.  The port's round loop never
synchronizes with the card (`repro_torch.core.dagm`), so per-round
solver health (the Eq. 17b outer-gap estimate, the penalty term, wire
bytes, the realized alive fraction under faults) would cost a sync per
round to read.  The flight recorder keeps those scalars on the device:
a preallocated `(capacity, len(FIELDS))` f32 ring buffer plus an int32
write count ride the chunk carry, and each round writes one row at
`count % capacity` with tensor ops only — no `.item()`, no host copy, no
shape that depends on data.  With `recorder=None`, `dagm_run_chunk`
runs exactly the loop it ran without it, and with it on the (x, y)
trajectory is unchanged bit for bit: the recorder only reads the
round's metrics and counters.

Field semantics (`FIELDS` order), as `repro`'s:

  round          global outer-round index — the recorder's cumulative
                 write count, so it keeps counting across chunks and
                 checkpoint restores.
  outer_gap_sq   ‖∇̂F‖² of the Eq. (17b) hyper-gradient estimate.
  penalty        γₖ · consensus_error(x) (0 when a custom metrics_fn
                 does not expose `consensus_x`).
  wire_bytes     cumulative exact wire bytes this trajectory has sent:
                 Σ_channels sends · bytes_per_send.  The port's send
                 counters are host integers, so this is a host number
                 written into the row (no sync either way).
  alive_fraction this round's realized / nominal directed links under
                 the fault mask (1.0 on unmasked runs).

On a serve bucket the buffer gains a leading job axis: rows (jobs,
capacity, F) and count (jobs,), one row per job per round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

#: Column order of the flight-row buffer.
FIELDS = ("round", "outer_gap_sq", "penalty", "wire_bytes",
          "alive_fraction")


@dataclasses.dataclass(frozen=True)
class RecorderSpec:
    """Flight-recorder configuration (hashable; the device state lives
    in the carry, not here)."""
    capacity: int = 1024

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(
                f"RecorderSpec.capacity must be >= 1, got "
                f"{self.capacity}")


class FlightBuffer(NamedTuple):
    """The recorder's carry leaf: rows + write count, both on the
    device ((capacity, F) and () solo; (jobs, capacity, F) and (jobs,)
    on a serve bucket)."""
    rows: Any                 # f32
    count: Any                # int32 — total writes ever


def recorder_init(spec: RecorderSpec, device=None) -> FlightBuffer:
    """Fresh all-zeros buffer on `device`."""
    return FlightBuffer(
        rows=torch.zeros((spec.capacity, len(FIELDS)), dtype=torch.float32,
                         device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def recorder_write(rec: FlightBuffer, values: dict) -> FlightBuffer:
    """Append one row (per job on a bucket) at count % capacity.

    `values` maps field name → scalar tensor (or (jobs,) tensor) for
    every field except `round`, which the recorder fills from its own
    write count.  Tensor ops only: no host synchronization."""
    cap = rec.rows.shape[-2]
    cols = [rec.count.to(torch.float32)] + [
        torch.as_tensor(values[f], dtype=torch.float32,
                        device=rec.rows.device).expand_as(
                            rec.count.to(torch.float32))
        for f in FIELDS[1:]]
    row = torch.stack(cols, dim=-1)                    # (..., F)
    idx = torch.remainder(rec.count, cap).long()
    onehot = (torch.arange(cap, device=rec.rows.device)
              == idx[..., None])[..., None]            # (..., cap, 1)
    rows = torch.where(onehot, row[..., None, :], rec.rows)
    return FlightBuffer(rows=rows, count=rec.count + 1)


def flight_values(metrics: dict, wire_bytes, gamma, *, mask=None,
                  offdiag_valid=None) -> dict:
    """One round's field values from what the round already has in
    hand: its metrics (device scalars or (jobs,) tensors), the
    cumulative wire bytes (a host number or (jobs,) host array, from
    the host send counters), γₖ, and under faults the round's (n, k_max)
    mask with the table's real off-diagonal slots (`wire_constants`)."""
    gap = metrics["hypergrad_est_norm_sq"]
    zero = torch.zeros_like(gap)
    cons = metrics.get("consensus_x")
    penalty = zero if cons is None \
        else torch.as_tensor(gamma, dtype=torch.float32,
                             device=gap.device) * cons
    wire = torch.as_tensor(np.asarray(wire_bytes, np.float32),
                           device="cpu").to(gap.device, non_blocking=True)
    if mask is None or offdiag_valid is None:
        alive = torch.ones_like(gap)
    else:
        valid = torch.as_tensor(np.asarray(offdiag_valid, np.float32),
                                device=gap.device)
        nominal = float(np.asarray(offdiag_valid).sum())
        alive = torch.sum(torch.as_tensor(mask, dtype=torch.float32,
                                          device=gap.device) * valid) \
            / max(nominal, 1.0)
    return {"outer_gap_sq": gap, "penalty": penalty,
            "wire_bytes": wire, "alive_fraction": alive}


def wire_constants(W) -> tuple[dict, "np.ndarray | None"]:
    """Host constants the flight rows need from a MixingOp:
    {channel: exact wire bytes per send} from the op's ledger, and the
    (n, k_max) float mask of *real off-diagonal* entries in the padded
    neighbor table (padding slots point at the row's own index and do
    not count toward the alive fraction); None without sparse tables."""
    bps = {name: ch.bytes_per_send
           for name, ch in W.ledger.channels.items()}
    sp = getattr(W, "sparse", None)
    valid = None
    if sp is not None:
        valid = (np.asarray(sp.neighbors)
                 != np.arange(sp.n)[:, None]).astype(np.float32)
    return bps, valid


def wire_bytes_sent(cs: dict, bytes_per_send: dict):
    """Σ_channels sends · bytes_per_send from the channels' host send
    counters (ints, or (jobs,) arrays on a bucket)."""
    total = 0
    for name, st in cs.items():
        bps = bytes_per_send.get(name)
        if bps:
            total = total + np.asarray(st.sends, np.float64) * float(bps)
    return total


# ---------------------------------------------------------------------------
# Host-side read-out
# ---------------------------------------------------------------------------

def recorder_rows(rec: FlightBuffer) -> np.ndarray:
    """The buffer's surviving rows, oldest-first — (min(count, cap),
    len(FIELDS)) float32 on the host.  Call after the run (a device
    sync, like any result read)."""
    rows = rec.rows.detach().cpu().numpy() \
        if isinstance(rec.rows, torch.Tensor) else np.asarray(rec.rows)
    count = int(rec.count.item() if isinstance(rec.count, torch.Tensor)
                else np.asarray(rec.count))
    cap = rows.shape[0]
    if count <= cap:
        return rows[:count]
    start = count % cap
    return np.concatenate([rows[start:], rows[:start]], axis=0)


def rows_to_dicts(rows: np.ndarray) -> list[dict]:
    """[{field: float}] per row — the shape `synthesize_round_spans`
    takes as `round_args` and the JSONL sink serializes."""
    return [{f: float(v) for f, v in zip(FIELDS, row)} for row in rows]
