"""Wrappers for the gossip CUDA kernels in `csrc/mixing_matvec.cu`.

Counterparts of `repro.kernels.mixing_matvec`:

  * `circulant_mix_matvec`   — W·Y or (I−W)·Y for circulant W,
  * `sparse_mix_matvec`      — the same for any W from padded (n, k)
                               neighbor/weight tables,
  * `circulant_neumann_step` — one fused DIHGP Neumann iteration
                               h⁺ = (D̃h − (I−W)h − β·hvp_h − p)/D̃,
  * `ring_laplacian_matvec`  — (I−W)·Y for a ring, over the circulant
                               kernel,
  * `circulant_mix_matvec_halo`, `sparse_mix_matvec_halo` — the
    row-tiled twins of the first two, for large n (below).

With ``comm="int8" | "int4"`` (and ``"+ef"`` for the two mixes) the
first three take `repro`'s extra operands — the per-row wire metadata
zp and scale ((n, 1) f32 from `repro_torch.comm.row_quant_params`), the
send's seed (a Python int) and, under error feedback, the replica `hat`
— and launch their comm-fused twin: the neighbor rows are replaced by
their stochastically quantized broadcast, the self term stays exact,
and ``+ef`` returns (out, payload) with payload = hat + C(y − hat).
The fused operand is f32 only.  ``comm=None`` or ``"identity"`` is the
plain kernel.

Dispatch is by the operand's device and nothing else: a CPU tensor runs
the plain PyTorch version (`repro_torch.kernels.ref`, in f32 — the
kernels accumulate in f32 for bf16 inputs too); a CUDA tensor launches
the kernel on PyTorch's current stream or raises.  Outputs have the
input's dtype and are allocated here with `torch.empty`.

The kernels take any n ≥ 1 and any d (the ragged edge is masked), f32
or bf16.  The circulant offsets and weights are device tables of any
length, as the sparse kernel's are (`circulant_tables` builds them).
Like the gather indices they are not range-checked here: that would
synchronize every launch.  No autograd: like `repro`'s Pallas tiers they
register no backward, so an operand that requires grad is refused.

Each kernel's launches are counted in `launch_counts()`, bumped only
where a wrapper launches it; the comm-fused kernels count apart from the
plain ones (`*_comm`), `ring_laplacian_matvec` apart from
`circulant_mix_matvec`, the plain circulant mix's and Neumann step's
unstaged kernels (`circulant_mix_matvec_unstaged`,
`circulant_neumann_step_unstaged`) apart from their rings
(`circulant_mix_matvec`, `circulant_neumann_step`), the full-operand
gossips' unstaged kernels
(`sparse_mix_matvec_unstaged`, `sparse_mix_matvec_comm_unstaged`,
`circulant_mix_matvec_comm_unstaged`, n > 14,528) apart from their
column stripes (`sparse_mix_matvec`, `sparse_mix_matvec_comm`,
`circulant_mix_matvec_comm`), the comm-fused Neumann step's unstaged
kernel (`circulant_neumann_step_comm_unstaged`) apart from its decoded
stripe (`circulant_neumann_step_comm`), and the sparse halo gathers'
row-tiled kernels
(`sparse_mix_matvec_halo_rows`, `sparse_mix_matvec_halo_comm_rows`) apart
from their column slabs (`sparse_mix_matvec_halo`,
`sparse_mix_matvec_halo_comm`).  `reset_launch_counts` zeroes them all.  Every
launch goes through `_cuda_lib.CudaLibrary`, the port's one ctypes
launch path.

The job axis (a serve bucket's gossip, `repro_torch.serve`): the plain
Neumann step with β as a (B,) device table and D̃ as (n, B), and every
comm-fused gossip (the full-operand ones, the halo ones and the Neumann
step) with zp/scale as (n, B) and a list of B seeds, launch their
`*_jobs` entry points on every route (the kernels' `JobAxis`: column c
is job c // (d / B)'s); each job's columns equal its solo launch bit for
bit.  These launches count apart, as the route's counter with `_jobs`
(`JOB_COUNTERS`).

Row tiles and the shared-memory planner
---------------------------------------
`repro` keeps a full (n, 128) column stripe of the operand resident in
a TPU core's VMEM and switches to its row-tiled halo kernels when the
stripe's live buffers outgrow a 4 MB budget, at n ≈ 4096.  On the H100
the counterpart of VMEM is the dynamic shared memory one block may opt
into, `SMEM_BUDGET_BYTES` = 232,448 B (227 KB): the halo kernels stage
a (h_lo + bn + h_hi, 128) row tile there.  The planner keeps `repro`'s
rules and its meaning of `blocks`, the variant's live (rows, 128)
buffers (`plan_blocks`: 3 plain, 4 fused, 6 fused + EF), and only swaps
the budget (and drops the TPU's sublane rule):

  * the full operand while `stripe_smem_bytes(n, blocks=…)` fits:
    n·128·4·3 ≤ 232,448 up to n = 151 for plain f32, so the n = 16
    runs keep the full-operand kernels;
  * else `pick_halo_bn`: the largest power of two bn ∈ {2048, …, 8} with
    bn | n, halo extents ≤ bn and (h_lo + bn + h_hi)·128·itemsize·blocks
    within the budget — at n = 4096 on the ring bn = 128 for the plain
    mix and 64 for the fused ones;
  * else no tile: `MixingOp` runs the full-operand kernel.

The halo kernels need no more than the planner counts: the plain
circulant kernel stages its tiles on a ring of `halo_stages` buffers (3
at the planner's bn, fewer where a wider tile is asked for), the fused
one a ring of `halo_comm_stages` raw stages (3, or 2 of y and hat under
EF) beside one decoded tile, the sparse row tiles one tile per block.
Each wrapper sizes its launch with the same `halo_smem_bytes`, asserts
that it lies within the plan for its bn, and the C entry point
recomputes it from the stage count and refuses a launch that
disagrees.
The halo wrappers take the circulant offsets and weights as host
sequences (`structure.offsets`), so the extents never come from the
card; their signed (k,) device tables are built once per graph and
device and cached.  Results do not depend on bn: plain outputs, fused
payloads and fused outputs equal the full-operand kernels' bit for bit.

The sparse gathers on the halo tier do not tile rows where they can
help it: an irregular graph's neighbors lie anywhere in the operand, so
a row tile gathers each neighbor value from device memory (and, with
``comm``, decodes it there, k hashes per element).  `plan_slab_cols`
instead gives each block a column slab of c columns over all n rows in
shared memory (32 bytes of a row: c = 8 f32, 16 bf16 at n = 4096),
gathered from there (and decoded once, one hash per element); the
row-tiled kernels run only where no slab fits (n > 33,536 in f32).  The
plain slab takes a row plan (`sparse_row_plan`: the rows in degree
order, each row's real slots), which `MixingOp` builds once per graph.
The choice is by shape alone and bn keeps its checks either way;
`smem_budget` lowers the budget to drive every route at a small n.

The plain full-operand sparse gather stages, as `repro`'s kernel does,
a column stripe of all n rows: `plan_stripe_cols` gives each block the
widest stripe of bc columns (512-byte rows down to 16: bc = 128 f32 up
to n = 454, 8 at n = 4121) whose (n, bc) tile fits `SMEM_BUDGET_BYTES`,
and the block gathers every neighbor row from there, so Y leaves device
memory once.  Above n = 14,528, where not even a 16-byte row fits, the
unstaged kernel reads each neighbor row from device memory.

The plain full-operand circulant mix and the DIHGP Neumann step run on
the circulant halo kernel's `cp.async` ring too: the mix at bn = n, one
row block holding the whole agent axis (`circulant_ring_stages`), the
step at the short row tile of `neumann_ring_plan` with h's extended
tile and the tiles of hvp_h and p on each stage.  Where no tile fits,
or where a launch would have fewer tiles than the card has SMs (the
n = 16 path's 2,010-wide operands), their unstaged kernels run.

The comm-fused full-operand gossips (sparse and circulant, ``comm=``)
stage the same f32 stripe and decode it in place, one hash per element,
writing the EF payload from that pass, then gather every neighbor's
decoded row from there (`plan_comm_stripe_cols`: the plain f32 widths,
narrowed where an operand as narrow as d2 = 2,010 would leave SMs
idle).  Above n = 14,528 their unstaged kernels decode each neighbor
value where it is gathered, k hashes per element.  The comm-fused
Neumann step decodes h's stripe the same way, with the Neumann update
as its epilogue, wherever `plan_neumann_comm_stripe_cols` gives a
stripe; its unstaged kernel keeps the operands with fewer 128-column
tiles than SMs (the n = 16 path's d2).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ._cuda_lib import CARD_SMS
from ._cuda_lib import DTYPE_CODE as _DTYPE_CODE
from ._cuda_lib import CudaLibrary
from ._cuda_lib import F as _F
from ._cuda_lib import I as _I
from ._cuda_lib import P as _P
from ._cuda_lib import U32 as _U
from ._cuda_lib import card_sms as _card_sms
from .ref import (check_halo_tile, circulant_mix_fused_ref,
                  circulant_mix_halo_ref, circulant_mix_ref, halo_extents,
                  is_seed_table, neumann_step_fused_ref, neumann_step_ref,
                  signed_offsets, sparse_mix_fused_ref, sparse_mix_halo_ref,
                  sparse_mix_padded_ref)

_INT_MAX = 2 ** 31 - 1
KERNEL_COMMS = ("int8", "int4", "int8+ef", "int4+ef")

# wire operands of the comm-fused kernels: zp, scale, seed, levels
_WIRE = (_P, _P, _U, _F)
# on a job axis: zp, scale, the host seed table, jobs, in-job columns,
# levels
_JOB_WIRE = (_P, _P, _P, _I, _I, _F)
# the most jobs one launch takes (the kernels' parameter-bank seed
# table; the serve engine's widest bucket)
MAX_JOBS = 64
# every entry point's arguments before the stream, which `CudaLibrary`
# appends
_LIB = CudaLibrary("mixing_matvec", {
    "circulant_mix": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _I),
    # ..., n, d, k, dtype, laplacian, stripe columns (0: the unstaged
    # kernel), smem bytes
    "sparse_mix": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I),
    "circulant_neumann": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P,
                          _F),
    # ..., beta, bn, h_lo, h_hi, stages, smem bytes
    "circulant_neumann_ring": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P,
                               _P, _F, _I, _I, _I, _I, _I),
    # ..., laplacian, stripe columns (0: the unstaged kernel), smem bytes
    "circulant_mix_comm": (_P, _P, _P, _P, *_WIRE, _I, _I, _F, _I, _P, _P,
                           _I, _I, _I),
    "sparse_mix_comm": (_P, _P, _P, _P, *_WIRE, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I),
    # ..., beta, stripe columns (0: the unstaged kernel), smem bytes
    "circulant_neumann_comm": (_P, _P, _P, _P, _P, *_WIRE, _I, _I, _F, _I,
                               _P, _P, _F, _I, _I),
    # the job-axis twins (a serve bucket's gossip): the host seed table,
    # jobs and in-job columns in place of the seed; a (jobs,) device beta
    # table in place of beta
    "circulant_neumann_jobs": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P,
                               _P, _P, _I, _I),
    "circulant_neumann_ring_jobs": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I),
    "circulant_mix_comm_jobs": (_P, _P, _P, _P, *_JOB_WIRE, _I, _I, _F, _I,
                                _P, _P, _I, _I, _I),
    "sparse_mix_comm_jobs": (_P, _P, _P, _P, *_JOB_WIRE, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I),
    "circulant_neumann_comm_jobs": (_P, _P, _P, _P, _P, *_JOB_WIRE, _I, _I,
                                    _F, _I, _P, _P, _P, _I, _I),
    # ..., bn, h_lo, h_hi, stages, smem bytes
    "circulant_mix_halo": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _I, _I, _I,
                           _I, _I, _I),
    # ..., bn, h_lo, h_hi, stages, smem bytes
    "circulant_mix_halo_comm": (_P, _P, _P, _P, *_WIRE, _I, _I, _F, _I, _P,
                                _P, _I, _I, _I, _I, _I, _I),
    # ..., row plan (order, deg), n, d, k, dtype, laplacian, bn, slab
    # columns (0: the row-tiled kernel), smem bytes
    "sparse_mix_halo": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I),
    # ..., bn, slab columns (0: the row-tiled kernel), smem bytes
    "sparse_mix_halo_comm": (_P, _P, *_WIRE, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I),
    "circulant_mix_halo_comm_jobs": (_P, _P, _P, _P, *_JOB_WIRE, _I, _I, _F,
                                     _I, _P, _P, _I, _I, _I, _I, _I, _I),
    "sparse_mix_halo_comm_jobs": (_P, _P, *_JOB_WIRE, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I),
})

# launches per kernel, under the names of chip_smoke's kernel list
_LAUNCHES = dict.fromkeys((
    "circulant_mix_matvec", "circulant_mix_matvec_unstaged",
    "sparse_mix_matvec", "sparse_mix_matvec_unstaged",
    "circulant_neumann_step", "circulant_neumann_step_unstaged",
    "circulant_mix_matvec_comm", "circulant_mix_matvec_comm_unstaged",
    "sparse_mix_matvec_comm", "sparse_mix_matvec_comm_unstaged",
    "circulant_neumann_step_comm", "circulant_neumann_step_comm_unstaged",
    "ring_laplacian_matvec",
    "circulant_mix_matvec_halo", "circulant_mix_matvec_halo_comm",
    "sparse_mix_matvec_halo", "sparse_mix_matvec_halo_rows",
    "sparse_mix_matvec_halo_comm", "sparse_mix_matvec_halo_comm_rows",
    # a serve bucket's job-axis launches, apart from the solo ones
    "circulant_neumann_step_jobs", "circulant_neumann_step_unstaged_jobs",
    "circulant_mix_matvec_comm_jobs",
    "circulant_mix_matvec_comm_unstaged_jobs",
    "sparse_mix_matvec_comm_jobs", "sparse_mix_matvec_comm_unstaged_jobs",
    "circulant_neumann_step_comm_jobs",
    "circulant_neumann_step_comm_unstaged_jobs",
    "circulant_mix_matvec_halo_comm_jobs",
    "sparse_mix_matvec_halo_comm_jobs",
    "sparse_mix_matvec_halo_comm_rows_jobs"), 0)

JOB_COUNTERS = tuple(name for name in _LAUNCHES if name.endswith("_jobs"))


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _launch(name: str, counter: str, dev: torch.device, *args) -> None:
    """Launch entry point `name` on `dev`'s current stream (raising when
    the launch is refused) and count it under `counter`."""
    _LIB.launch(name, dev, *args)
    _LAUNCHES[counter] += 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_state(name: str, t, shape=None, like=None) -> None:
    """A kernel operand of shape (n, d): f32/bf16, contiguous, no grad."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name} must be a non-empty (n, d) matrix, got "
                         f"shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} must be float32 or bfloat16, got "
                         f"{t.dtype}")
    if like is not None and (t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{like.dtype} on {like.device}")
    _check_common(name, t)
    if t.shape[0] > _INT_MAX or t.shape[1] > _INT_MAX:
        raise ValueError(f"{name} dimensions exceed int32: "
                         f"{tuple(t.shape)}")


def _check_table(name: str, t, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)} "
                         f"on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    _check_common(name, t)


def _check_common(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad; the mixing kernels have "
                         f"no backward (the algorithm never "
                         f"differentiates through a gossip)")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}; expected cpu or cuda")


def parse_kernel_comm(comm: str | None) -> tuple[int, bool] | None:
    """(bits, ef) for a fusable comm spec; None for the plain kernel."""
    if comm in (None, "identity"):
        return None
    if comm not in KERNEL_COMMS:
        raise ValueError(
            f"comm={comm!r} is not kernel-fusable; expected one of "
            f"{KERNEL_COMMS} (identity/top-k/rand-k/bf16 gossip composes "
            f"the compressor with the plain mix — see MixingOp)")
    base, _, opt = comm.partition("+")
    return int(base[3:]), opt == "ef"


def _check_seed(seed) -> None:
    if isinstance(seed, bool) or not isinstance(seed, int) \
            or not -2 ** 31 <= seed < 2 ** 32:
        raise TypeError(f"seed must be a Python int in the 32-bit range, "
                        f"got {seed!r}")


def _check_jobs(d: int, jobs: int) -> int:
    """The in-job columns of a job-axis launch over d columns."""
    if not 1 <= jobs <= MAX_JOBS or d % jobs:
        raise ValueError(f"a job axis of {jobs} jobs over {d} columns: "
                         f"the kernels take 1 to {MAX_JOBS} jobs of equal "
                         f"width")
    return d // jobs


def _check_wire(y, zp, scale, seed, hat, ef: bool) -> int:
    """The comm-fused kernels' operands: y f32 (n, d); zp, scale (n, 1)
    f32 on y's device; seed a Python int; hat (n, d) f32 iff EF.  On a
    job axis seed is a sequence of B ints and zp, scale are (n, B).
    Returns B (1 for a solo send)."""
    if y.dtype != torch.float32:
        raise ValueError(f"the comm-fused kernels take a float32 operand, "
                         f"got {y.dtype}")
    n = y.shape[0]
    jobs = 1
    if is_seed_table(seed):
        jobs = len(seed)
        _check_jobs(y.shape[1], jobs)
        for s in seed:
            _check_seed(int(s))
    else:
        _check_seed(seed)
    _check_table("zp", zp, (n, jobs), torch.float32, y.device)
    _check_table("scale", scale, (n, jobs), torch.float32, y.device)
    if ef:
        _check_state("hat", hat, y.shape, like=y)
    elif hat is not None:
        raise ValueError("hat is the error-feedback replica; pass it only "
                         "with comm='int8+ef' or 'int4+ef'")
    return jobs


def _seed_table(seeds):
    """A host array of a job axis's seeds for a launch (kept alive by
    the caller until the launch returns)."""
    return (ctypes.c_uint32 * len(seeds))(
        *(int(s) & 0xFFFFFFFF for s in seeds))


def _check_betas(beta, d_scalar, h) -> int:
    """A Neumann step's β: a Python number (solo; d_scalar (n, 1)) or
    a job axis's (B,) f32 table on h's device (d_scalar (n, B)).
    Returns B, 0 for a solo step."""
    n, d = h.shape
    if not isinstance(beta, torch.Tensor):
        _check_table("d_scalar", d_scalar, (n, 1), torch.float32, h.device)
        return 0
    jobs = beta.shape[0] if beta.dim() == 1 else -1
    _check_table("beta", beta, (jobs,), torch.float32, h.device)
    _check_jobs(d, jobs)
    _check_table("d_scalar", d_scalar, (n, jobs), torch.float32, h.device)
    return jobs


def circulant_tables(n: int, offsets, weights, device):
    """The circulant kernels' (k,) int32 offset and (k,) f32 weight
    tables on `device`, offsets reduced into [0, n)."""
    offsets = [int(o) % n for o in offsets]
    weights = [float(c) for c in weights]
    if len(offsets) != len(weights):
        raise ValueError(f"{len(offsets)} offsets but {len(weights)} "
                         f"weights")
    return (torch.tensor(offsets, dtype=torch.int32, device=device),
            torch.tensor(weights, dtype=torch.float32, device=device))


def _check_circulant(offsets, weights, device) -> int:
    k = offsets.shape[0] if isinstance(offsets, torch.Tensor) \
        and offsets.dim() == 1 else -1
    _check_table("offsets", offsets, (k,), torch.int32, device)
    _check_table("weights", weights, (k,), torch.float32, device)
    return k


def _is_host(offsets, weights) -> bool:
    """Whether a circulant W comes as host sequences (else as (k,) device
    tables, checked here; one of each is refused)."""
    if isinstance(offsets, torch.Tensor) or isinstance(weights, torch.Tensor):
        return False
    if len(offsets) != len(weights):
        raise ValueError(f"{len(offsets)} offsets but {len(weights)} "
                         f"weights")
    return True


def _circulant_host(n: int, offsets, weights, device):
    """The circulant W as host tuples, offsets in [0, n).  Device tables
    are read back (one synchronizing copy): hot paths pass host
    sequences (`structure.offsets`, `.weights`)."""
    if not _is_host(offsets, weights):
        _check_circulant(offsets, weights, device)
        offsets, weights = offsets.tolist(), weights.tolist()
    return (tuple(int(o) % n for o in offsets),
            tuple(float(c) for c in weights))


def _circulant_device(n: int, offsets, weights, device):
    """(k, offset table, weight table) of the full-operand kernels on
    `device`: the given (k,) device tables, or those of host sequences,
    built once per graph and device."""
    if _is_host(offsets, weights):
        off, w = _unsigned_tables(n, tuple(int(o) % n for o in offsets),
                                  tuple(float(c) for c in weights), device)
        return len(off), off, w
    return _check_circulant(offsets, weights, device), offsets, weights


@functools.lru_cache(maxsize=64)
def _unsigned_tables(n: int, offsets: tuple, weights: tuple, device):
    return circulant_tables(n, offsets, weights, device)


def _circulant_mix(counter: str, unstaged: str, y, w_self, offsets,
                   weights, laplacian, ring=None):
    """The plain circulant mix (or its plain version on the CPU): the
    ring at bn = n where `circulant_ring_stages` gives it stages (or at
    ring = (n, stages)), counted under `counter`, else the unstaged
    kernel, counted under `unstaged`."""
    _check_state("y", y)
    n, d = y.shape
    item = y.element_size()
    offs, ws = _circulant_host(n, offsets, weights, y.device)
    h_lo, h_hi = halo_extents(offs, n)
    one = halo_smem_bytes(h_lo + n + h_hi, itemsize=item)
    if ring is None:
        stages = circulant_ring_stages(n, h_lo, h_hi, itemsize=item, d=d)
    elif ring[0] != n or not 1 <= ring[1] <= HALO_STAGES \
            or ring[1] * one > SMEM_BUDGET_BYTES:
        raise ValueError(f"ring={ring}: the full-operand mix's ring has "
                         f"bn = n = {n} and 1 to {HALO_STAGES} stages of "
                         f"{one} B within {SMEM_BUDGET_BYTES} B")
    else:
        stages = ring[1]
    if y.device.type == "cpu":
        return circulant_mix_ref(y.float(), float(w_self), offs, ws,
                                 laplacian).to(y.dtype)
    out = torch.empty_like(y)
    if stages:
        smem = stages * one
        assert smem <= SMEM_BUDGET_BYTES
        soff, w = _signed_tables(n, offs, ws, y.device)
        _launch("circulant_mix_halo", counter, y.device, y.data_ptr(),
                out.data_ptr(), n, d, _DTYPE_CODE[y.dtype], float(w_self),
                len(offs), soff.data_ptr(), w.data_ptr(),
                int(bool(laplacian)), n, h_lo, h_hi, stages, smem)
        return out
    k, off, w = _circulant_device(n, offsets, weights, y.device)
    _launch("circulant_mix", unstaged, y.device, y.data_ptr(),
            out.data_ptr(), n, d, _DTYPE_CODE[y.dtype], float(w_self), k,
            off.data_ptr(), w.data_ptr(), int(bool(laplacian)))
    return out


def circulant_mix_matvec(y: torch.Tensor, zp=None, scale=None, seed=None,
                         hat=None, *, w_self: float, offsets, weights,
                         laplacian: bool = False,
                         comm: str | None = None,
                         ring: tuple[int, int] | None = None):
    """W·Y (or (I−W)·Y) for circulant W; y: (n, d) f32 or bf16.

    W[i, (i+o) mod n] = c_o for o, c_o in zip(offsets, weights),
    W[i, i] = w_self; offsets and weights as host sequences
    (`structure.offsets`, `.weights`; their device tables are built once
    per graph) or as (k,) int32 offsets in [0, n) and (k,) f32 weights
    on y's device (`circulant_tables`; the plain mix reads those back to
    plan its tile, one synchronizing copy).  f32 accumulation, output in
    y's dtype.

    The plain mix runs the circulant halo's ring at bn = n, one row block
    holding the whole agent axis (`circulant_ring_stages`), counted as
    `circulant_mix_matvec`; where that tile does not fit, or the rule
    there keeps the old kernel, the unstaged kernel runs, counted as
    `circulant_mix_matvec_unstaged`.  Both equal the plain version bit
    for bit.  ring: (n, stages) to run the ring with instead of the
    planner's choice (sweeps and tests), held to the same checks.

    `comm`, zp, scale, seed, hat: the comm-fused twin (module
    docstring); returns (out, payload) under ``+ef``.  The fused gossip
    decodes an (n, bc) column stripe per block where one fits
    (`plan_comm_stripe_cols`: n ≤ 14,528), counted as
    `circulant_mix_matvec_comm`, else runs its unstaged kernel, counted
    as `circulant_mix_matvec_comm_unstaged`; both equal the plain version
    bit for bit, output and payload."""
    fused = parse_kernel_comm(comm)
    if fused is None:
        return _circulant_mix("circulant_mix_matvec",
                              "circulant_mix_matvec_unstaged", y, w_self,
                              offsets, weights, laplacian, ring)
    if ring is not None:
        raise ValueError("ring= sizes the plain mix's tile; the comm-fused "
                         "mix stages a decoded stripe")
    bits, ef = fused
    _check_state("y", y)
    jobs = _check_wire(y, zp, scale, seed, hat, ef)
    n, d = y.shape
    if y.device.type == "cpu":
        offs, ws = _circulant_host(n, offsets, weights, y.device)
        return circulant_mix_fused_ref(
            y, zp, scale, seed, hat, w_self=float(w_self), offsets=offs,
            weights=ws, laplacian=laplacian, bits=bits)
    k, off, w = _circulant_device(n, offsets, weights, y.device)
    out = torch.empty_like(y)
    pay = torch.empty_like(y) if ef else None
    cols, smem = _comm_stripe(y)
    counter = "circulant_mix_matvec_comm" if cols \
        else "circulant_mix_matvec_comm_unstaged"
    head = (y.data_ptr(), out.data_ptr(), _ptr(pay), _ptr(hat),
            zp.data_ptr(), scale.data_ptr())
    tail = (float(2 ** bits - 1), n, d, float(w_self), k, off.data_ptr(),
            w.data_ptr(), int(bool(laplacian)), cols, smem)
    if is_seed_table(seed):
        table = _seed_table(seed)
        _launch("circulant_mix_comm_jobs", counter + "_jobs", y.device,
                *head, ctypes.addressof(table), jobs, d // jobs, *tail)
    else:
        _launch("circulant_mix_comm", counter, y.device, *head,
                seed & 0xFFFFFFFF, *tail)
    return (out, pay) if ef else out


def sparse_mix_matvec(y: torch.Tensor, w_self: torch.Tensor,
                      neighbors: torch.Tensor, weights: torch.Tensor,
                      zp=None, scale=None, seed=None, hat=None, *,
                      laplacian: bool = False, comm: str | None = None):
    """W·Y (or (I−W)·Y) for any W from padded tables; y: (n, d).

    w_self: (n,) f32 diagonal; neighbors: (n, k) int32 with every entry
    in [0, n); weights: (n, k) f32 — padded slots hold the row's own
    index with weight 0 (`repro_torch.topology.structure
    .sparse_structure`, which builds them in range from W).  Indices are
    not range-checked here: that would synchronize every launch.  `comm`
    and its operands as in `circulant_mix_matvec`; each gathered row is
    decoded with its source row's zp/scale.

    The plain gather stages an (n, bc) column stripe per block where one
    fits (`plan_stripe_cols`: n ≤ 14,528) and counts as
    `sparse_mix_matvec`; above that its unstaged kernel runs, counted as
    `sparse_mix_matvec_unstaged`.  Both equal the plain version bit for
    bit.  The fused gather likewise decodes its stripe
    (`plan_comm_stripe_cols`), counted as `sparse_mix_matvec_comm`, or
    runs its unstaged kernel, `sparse_mix_matvec_comm_unstaged`: output
    and payload bitwise the plain version's on both."""
    fused = parse_kernel_comm(comm)
    _check_state("y", y)
    n, d = y.shape
    k = neighbors.shape[1] if neighbors.dim() == 2 else -1
    _check_table("w_self", w_self, (n,), torch.float32, y.device)
    _check_table("neighbors", neighbors, (n, k), torch.int32, y.device)
    _check_table("weights", weights, (n, k), torch.float32, y.device)
    if fused is None:
        if y.device.type == "cpu":
            return sparse_mix_padded_ref(y.float(), w_self, neighbors,
                                         weights, laplacian).to(y.dtype)
        out = torch.empty_like(y)
        cols = plan_stripe_cols(n, y.element_size())
        smem = 0 if cols is None else stripe_bytes(n, cols,
                                                   y.element_size())
        assert smem <= SMEM_BUDGET_BYTES
        _launch("sparse_mix", "sparse_mix_matvec" if cols is not None
                else "sparse_mix_matvec_unstaged", y.device, y.data_ptr(),
                out.data_ptr(), w_self.data_ptr(), neighbors.data_ptr(),
                weights.data_ptr(), n, d, k, _DTYPE_CODE[y.dtype],
                int(bool(laplacian)), cols or 0, smem)
        return out
    bits, ef = fused
    jobs = _check_wire(y, zp, scale, seed, hat, ef)
    if y.device.type == "cpu":
        return sparse_mix_fused_ref(y, w_self, neighbors, weights, zp,
                                    scale, seed, hat, laplacian=laplacian,
                                    bits=bits)
    out = torch.empty_like(y)
    pay = torch.empty_like(y) if ef else None
    cols, smem = _comm_stripe(y)
    counter = "sparse_mix_matvec_comm" if cols \
        else "sparse_mix_matvec_comm_unstaged"
    head = (y.data_ptr(), out.data_ptr(), _ptr(pay), _ptr(hat),
            zp.data_ptr(), scale.data_ptr())
    tail = (float(2 ** bits - 1), w_self.data_ptr(), neighbors.data_ptr(),
            weights.data_ptr(), n, d, k, int(bool(laplacian)), cols, smem)
    if is_seed_table(seed):
        table = _seed_table(seed)
        _launch("sparse_mix_comm_jobs", counter + "_jobs", y.device,
                *head, ctypes.addressof(table), jobs, d // jobs, *tail)
    else:
        _launch("sparse_mix_comm", counter, y.device, *head,
                seed & 0xFFFFFFFF, *tail)
    return (out, pay) if ef else out


def circulant_neumann_step(h: torch.Tensor, hvp_h: torch.Tensor,
                           p: torch.Tensor, d_scalar: torch.Tensor,
                           zp=None, scale=None, seed=None, *,
                           w_self: float, offsets, weights, beta: float,
                           comm: str | None = None,
                           ring: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """One fused DIHGP Neumann iteration (Eq. 14) for circulant W:

        h⁺ = (D̃h − (I−W)h − β·hvp_h − p) / D̃

    h, hvp_h, p: (n, d), one dtype (f32; bf16 is accepted and
    accumulated in f32); d_scalar: (n, 1) f32 per-agent D̃; the
    circulant W as in `circulant_mix_matvec`; β a Python number (a
    runtime kernel argument).

    The step runs on the circulant halo's ring wherever
    `neumann_ring_plan` gives it a row tile (bn, stages), counted as
    `circulant_neumann_step`, else the unstaged kernel, counted as
    `circulant_neumann_step_unstaged`; both equal the plain version bit
    for bit.  ring: a (bn, stages) to run instead of the planner's
    (sweeps and tests), held to the same checks.

    ``comm="int8" | "int4"`` with zp, scale and seed quantizes the W·h
    gossip in the same pass; error feedback is refused, as `repro`
    refuses it (no payload write-back).  The fused step decodes h's
    (n, bc) column stripe once per block wherever
    `plan_neumann_comm_stripe_cols` gives one, counted as
    `circulant_neumann_step_comm`, else runs its unstaged kernel,
    counted as `circulant_neumann_step_comm_unstaged`; both equal the
    plain version bit for bit."""
    if parse_kernel_comm(comm) is not None:
        if ring is not None:
            raise ValueError("ring= sizes the plain Neumann step's tile; "
                             "the comm-fused step has none")
        return _neumann_comm_launch(h, hvp_h, p, d_scalar, zp, scale, seed,
                                    w_self=w_self, offsets=offsets,
                                    weights=weights, beta=beta, comm=comm)
    _check_state("h", h)
    _check_state("hvp_h", hvp_h, h.shape, like=h)
    _check_state("p", p, h.shape, like=h)
    n, d = h.shape
    jobs = _check_betas(beta, d_scalar, h)
    offs, ws = _circulant_host(n, offsets, weights, h.device)
    item = h.element_size()
    h_lo, h_hi = halo_extents(offs, n)
    plan = neumann_ring_plan(n, h_lo, h_hi, itemsize=item, d=d) \
        if ring is None else ring
    if plan is not None:
        bn, stages = plan
        check_halo_tile(n, bn, h_lo, h_hi)
        smem = stages * neumann_stage_bytes(bn, h_lo, h_hi,
                                            itemsize=item)
        if not 1 <= stages <= HALO_STAGES \
                or smem > SMEM_BUDGET_BYTES:
            raise ValueError(
                f"ring={plan}: {stages} stages of "
                f"{neumann_stage_bytes(bn, h_lo, h_hi, itemsize=item)}"
                f" B; the kernel takes 1 to {HALO_STAGES} "
                f"within {SMEM_BUDGET_BYTES} B")
    if h.device.type == "cpu":
        return neumann_step_ref(h.float(), hvp_h.float(), p.float(),
                                d_scalar, w_self=float(w_self),
                                offsets=offs, weights=ws,
                                beta=beta if jobs else float(beta)
                                ).to(h.dtype)
    out = torch.empty_like(h)
    operands = (h.data_ptr(), hvp_h.data_ptr(), p.data_ptr(),
                d_scalar.data_ptr(), out.data_ptr(), n, d,
                _DTYPE_CODE[h.dtype], float(w_self))
    # β: the launch's scalar, or a job axis's (B,) table, B, in-job cols
    betas = (beta.data_ptr(), jobs, d // jobs) if jobs \
        else (float(beta),)
    suffix = "_jobs" if jobs else ""
    if plan is not None:
        soff, w = _signed_tables(n, offs, ws, h.device)
        _launch("circulant_neumann_ring" + suffix,
                "circulant_neumann_step" + suffix, h.device, *operands,
                len(offs), soff.data_ptr(), w.data_ptr(), *betas, bn, h_lo,
                h_hi, stages, smem)
        return out
    k, off, w = _circulant_device(n, offsets, weights, h.device)
    _launch("circulant_neumann" + suffix,
            "circulant_neumann_step_unstaged" + suffix, h.device,
            *operands, k, off.data_ptr(), w.data_ptr(), *betas)
    return out


def _neumann_comm_launch(h, hvp_h, p, d_scalar, zp, scale, seed, *,
                         w_self, offsets, weights, beta, comm,
                         cols: int | None = None) -> torch.Tensor:
    """`circulant_neumann_step` with comm=: the decoded stripe at
    `plan_neumann_comm_stripe_cols`' width, or, given cols, at that
    width, or the unstaged kernel at cols=0 (sweeps and tests), held to
    the same checks."""
    bits, ef = parse_kernel_comm(comm)
    _check_state("h", h)
    _check_state("hvp_h", hvp_h, h.shape, like=h)
    _check_state("p", p, h.shape, like=h)
    n, d = h.shape
    jobs = _check_betas(beta, d_scalar, h)
    if ef:
        raise ValueError("the fused Neumann kernel does not lower '+ef' "
                         "comm (no payload write-back); compose it from "
                         "mix_c and the Neumann update instead")
    if _check_wire(h, zp, scale, seed, None, False) != max(jobs, 1) \
            or bool(jobs) != is_seed_table(seed):
        raise ValueError("a job-axis Neumann step takes β as a (B,) "
                         "table and B seeds; a solo one a number and one "
                         "seed")
    if cols is not None and cols != 0 and (
            cols not in stripe_cols_for(4)
            or stripe_bytes(n, cols) > SMEM_BUDGET_BYTES):
        raise ValueError(f"cols={cols}: the decoded stripe takes one of "
                         f"{stripe_cols_for(4)} columns within "
                         f"{SMEM_BUDGET_BYTES} B (n = {n}), or 0 for the "
                         f"unstaged kernel")
    if h.device.type == "cpu":
        offs, ws = _circulant_host(n, offsets, weights, h.device)
        return neumann_step_fused_ref(h, hvp_h, p, d_scalar, zp, scale,
                                      seed, w_self=float(w_self),
                                      offsets=offs, weights=ws,
                                      beta=beta if jobs else float(beta),
                                      bits=bits)
    k, off, w = _circulant_device(n, offsets, weights, h.device)
    out = torch.empty_like(h)
    if cols is None:
        cols = plan_neumann_comm_stripe_cols(n, d, _card_sms(h.device)) or 0
    smem = stripe_bytes(n, cols) if cols else 0
    assert smem <= SMEM_BUDGET_BYTES
    counter = "circulant_neumann_step_comm" if cols \
        else "circulant_neumann_step_comm_unstaged"
    head = (h.data_ptr(), hvp_h.data_ptr(), p.data_ptr(),
            d_scalar.data_ptr(), out.data_ptr(), zp.data_ptr(),
            scale.data_ptr())
    mid = (float(2 ** bits - 1), n, d, float(w_self), k, off.data_ptr(),
           w.data_ptr())
    if jobs:
        table = _seed_table(seed)
        _launch("circulant_neumann_comm_jobs", counter + "_jobs", h.device,
                *head, ctypes.addressof(table), jobs, d // jobs, *mid,
                beta.data_ptr(), cols, smem)
    else:
        _launch("circulant_neumann_comm", counter, h.device, *head,
                seed & 0xFFFFFFFF, *mid, float(beta), cols, smem)
    return out


def ring_offsets(n: int, w_edge: float):
    """The ring's circulant offsets and weights: (1, n−1), or the single
    offset (1,) for n = 2, where ±1 name the same neighbor."""
    if n == 2:
        return (1,), (w_edge,)
    return (1, n - 1), (w_edge, w_edge)


def ring_laplacian_matvec(y: torch.Tensor, *, w_self: float,
                          w_edge: float) -> torch.Tensor:
    """(I − W)·Y for ring W (`repro`'s compatibility wrapper over the
    plain circulant mix, on its route; counted as
    `ring_laplacian_matvec` on both); y: (n, d) f32 or bf16, any n ≥ 2
    and d."""
    offsets, weights = ring_offsets(y.shape[0], float(w_edge))
    return _circulant_mix("ring_laplacian_matvec", "ring_laplacian_matvec",
                          y, w_self, offsets, weights, True)


# ---------------------------------------------------------------------------
# Row tiles: the shared-memory planner and the halo entry points
# ---------------------------------------------------------------------------

SMEM_BUDGET_BYTES = 232_448
HALO_BD = 128
HALO_BNS = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)


def plan_blocks(fused: bool, ef: bool = False) -> int:
    """Live (rows, 128) buffers of a mix variant, as `repro` counts them:
    3 plain (input, f32 accumulator, output), 4 fused (+ payload), 6
    fused with EF (+ replica and payload output)."""
    return 6 if fused and ef else 4 if fused else 3


def halo_smem_bytes(rows: int, *, itemsize: int = 4,
                    blocks: int = 1) -> int:
    """Shared memory of `blocks` (rows, HALO_BD) buffers: what the
    planner counts for a tile, and (blocks=1) what a halo launch
    stages."""
    return rows * HALO_BD * itemsize * blocks


HALO_STAGES = 3


def halo_stages(rows: int, *, itemsize: int = 4) -> int:
    """The staged circulant kernel's ring: the most buffers of a
    (rows, HALO_BD) tile, up to `HALO_STAGES`, within
    `SMEM_BUDGET_BYTES` (read at the call); 3 at the planner's bn, whose
    plan counts 3 live buffers (`plan_blocks(False)`); 0 when not even
    one fits."""
    return min(HALO_STAGES, SMEM_BUDGET_BYTES
               // halo_smem_bytes(rows, itemsize=itemsize))


HALO_COMM_STAGES = 3       # the fused ring's raw stages without EF
HALO_COMM_EF_STAGES = 2    # and with it (a y and a hat tile each)


def halo_comm_stages(rows: int, *, ef: bool) -> int:
    """The fused circulant halo kernel's ring: the most raw stages, up to
    `HALO_COMM_STAGES` (`HALO_COMM_EF_STAGES` under EF, each a y and a hat
    tile), that fit `SMEM_BUDGET_BYTES` (read at the call) beside the one
    decoded tile, of (rows, HALO_BD) f32 tiles; 3 (2 under EF) at the
    planner's bn, whose plan counts 4 (6) live buffers
    (`plan_blocks(True, ef)`); 0 when not even one stage fits."""
    tiles = SMEM_BUDGET_BYTES // halo_smem_bytes(rows)
    most = HALO_COMM_EF_STAGES if ef else HALO_COMM_STAGES
    return max(0, min(most, (tiles - 1) // (2 if ef else 1)))


def halo_comm_buffers(stages: int, *, ef: bool) -> int:
    """Tiles a fused circulant halo launch stages: the ring's raw stages
    (a y and a hat tile each under EF) and the decoded tile."""
    return stages * (2 if ef else 1) + 1


# The plain full-operand circulant mix and the DIHGP Neumann step on the
# circulant halo's ring (`circulant_mix_halo_kernel` at bn = n and
# `circulant_neumann_ring_kernel` in csrc/mixing_matvec.cu): the
# Neumann step's stage holds h's extended tile and the (bn, 128) tiles of
# hvp_h and p.  Both rules come from chip_smoke.py's `ring_sweep_phase`
# and `neumann_on_solve_operands` (H100 80GB HBM3, 700 W; device ms, every
# (bn, stages) bitwise the unstaged kernel's):
#
#   Neumann, (4096, 2010) f32: unstaged 0.06962; bn 8: 0.06033 / 0.05432
#     / 0.05550 at 1-3 stages; bn 16: 0.05444 / 0.05855 / 0.06571; bn 32:
#     0.05849 / 0.06449 / 0.07051; bn 64: 0.06482 / 0.07497; bn 128:
#     0.08640; bn 4: 0.07463 at 2.
#   (4096, 157000) f32: unstaged 5.15263; bn 8: 4.05339 / 3.87441 /
#     3.94812; bn 16: 3.90331 / 3.91114 / 3.79861; bn 32: 3.94416 /
#     3.90766 / 3.88765; bn 64: 3.96072 / 4.13864; bn 4: 4.77641 at 2.
#   (4096, 2010) bf16: unstaged 0.06431; bn 32: 0.04564 / 0.04079 /
#     0.04162; bn 16: 0.04749 at 2; bn 64: 0.04253 at 2; bn 8: 0.06423
#     at 2.  (4096, 157000) bf16: unstaged 4.73325; bn 32: 2.50357 /
#     2.40247 / 2.44220; bn 64: 2.38083 / 2.42998 / 2.34950; bn 16:
#     2.49224 at 2; bn 8: 4.35280 at 2.
#   (16, 2010) f32: unstaged 0.00225; the ring's best 0.00321 (bn 4, 2
#     stages), bn 16 0.00416.  (16, 157000): unstaged 0.02313; bn 16
#     0.01756 / 0.01697, bn 8 0.01890 / 0.01667 at 1-2 stages.
#   Mix at bn = n, 1-3 stages: (16, 2010) unstaged 0.00200, ring 0.00281
#     / 0.00283 / 0.00286; (16, 157000) 0.01526 against 0.00882 /
#     0.00767 / 0.00804; (128, 157000) 0.11748 against 0.06623 / 0.06924
#     / 0.06834.
#   On the operands the n = 4096 ring identity solve hands the step (83%
#     of h zeros, 2% subnormal, which send f32 division down its slow
#     path), (4096, 2010) f32, in one run: unstaged 0.07883; bn 8:
#     0.08091 / 0.07537 / 0.07575 at 1-3 stages; bn 16: 0.06900 /
#     0.07255 at 1-2; bn 32: 0.06932 at 1; and on random operands in
#     that run 0.06985; 0.06004 / 0.05439 / 0.05555; 0.05432 / 0.05853;
#     0.05813.
#
# So the Neumann ring takes short tiles (more blocks on an SM, whose warps
# hide each other's copies and divisions): 16 rows and 1 stage f32, the
# fastest on the solve's operands and as fast as any on random ones at
# d2 (the step's only width on the main path), and 32 rows and 2 stages
# bf16; both rings give way to the unstaged kernels where their launch
# has fewer tiles than the card has SMs (ceil(d/128) · n/bn < 132: the
# (16, 2010) operands of the n = 16 path), where one block per tile
# leaves the card idle behind a chain of copy, wait and mix that the
# unstaged kernels' single round of loads does not have.
# the planner's (row tile, stages) by itemsize
NEUMANN_RING_TILE = {4: (16, 1), 2: (32, 2)}


def _fills_card(n: int, bn: int, d: int | None, sms: int) -> bool:
    """Whether a ring launch of row tile bn over an (n, d) operand has
    at least one tile per SM (always, when d is not given)."""
    return d is None or n // bn * -(-d // HALO_BD) >= sms


def circulant_ring_stages(n: int, h_lo: int = 0, h_hi: int = 0, *,
                          itemsize: int = 4, d: int | None = None,
                          sms: int = CARD_SMS) -> int:
    """Stages of the plain full-operand circulant mix on the ring at
    bn = n: `halo_stages` of the (h_lo + n + h_hi)-row tile (3 on the
    ring at n = 16), or 0, for the unstaged kernel, where not one fits
    `SMEM_BUDGET_BYTES` (read at the call; n > 452 f32 on the ring) or,
    given d, where the operand has fewer 128-column tiles than the
    card's `sms` SMs (d ≤ 16,768 on the H100: the n = 16 path's d2)."""
    if not _fills_card(n, n, d, sms):
        return 0
    return halo_stages(h_lo + n + h_hi, itemsize=itemsize)


def neumann_stage_bytes(bn: int, h_lo: int = 0, h_hi: int = 0, *,
                        itemsize: int = 4) -> int:
    """One stage of the Neumann ring: h's (h_lo + bn + h_hi)-row tile and
    the (bn, 128) tiles of hvp_h and p."""
    return halo_smem_bytes(h_lo + 3 * bn + h_hi, itemsize=itemsize)


def neumann_ring_plan(n: int, h_lo: int = 0, h_hi: int = 0, *,
                      itemsize: int = 4, d: int | None = None,
                      sms: int = CARD_SMS) -> tuple[int, int] | None:
    """(bn, stages) of the Neumann step on the circulant ring, or None
    for the unstaged kernel.  bn: among n and the powers of two in
    `HALO_BNS` and 4 and 2 that divide n, hold the halo extents and
    whose stage (`neumann_stage_bytes`) fits `SMEM_BUDGET_BYTES` (read at
    the call), the tallest of at most the rows of
    `NEUMANN_RING_TILE[itemsize]` (16 f32 at n = 16 and 4096, 32 bf16 at
    4096; 4 at n = 100; 7 at n = 7), else the shortest; stages: up to
    the stages there that fit (1 f32, 2 bf16).  None where no tile
    qualifies (a prime n over 150 in f32) or, given d, where the launch
    would have fewer tiles than the card's `sms` SMs (the n = 16 path's
    d2)."""
    tiles = [bn for bn in sorted({n, *HALO_BNS, 4, 2})
             if bn <= n and n % bn == 0 and bn >= max(h_lo, h_hi)
             and neumann_stage_bytes(bn, h_lo, h_hi, itemsize=itemsize)
             <= SMEM_BUDGET_BYTES]
    if not tiles:
        return None
    rows, stages = NEUMANN_RING_TILE[itemsize]
    short = [bn for bn in tiles if bn <= rows]
    bn = short[-1] if short else tiles[0]
    if not _fills_card(n, bn, d, sms):
        return None
    return bn, min(stages, SMEM_BUDGET_BYTES
                   // neumann_stage_bytes(bn, h_lo, h_hi,
                                          itemsize=itemsize))


def stripe_smem_bytes(n: int, *, itemsize: int = 4, blocks: int = 3) -> int:
    """A full (n, HALO_BD) column stripe's live buffers (`repro`'s
    `stripe_vmem_bytes`)."""
    return halo_smem_bytes(n, itemsize=itemsize, blocks=blocks)


def pick_halo_bn(n: int, *, h_lo: int = 0, h_hi: int = 0,
                 itemsize: int = 4, blocks: int = 3) -> int | None:
    """Largest row tile bn in `HALO_BNS` with bn | n, halo extents ≤ bn
    and the extended tile's `blocks` buffers within `SMEM_BUDGET_BYTES`
    (read at the call); None when none qualifies."""
    for bn in HALO_BNS:
        if n % bn or bn < max(h_lo, h_hi):
            continue
        if halo_smem_bytes(h_lo + bn + h_hi, itemsize=itemsize,
                           blocks=blocks) <= SMEM_BUDGET_BYTES:
            return bn
    return None


def plan_row_tile(n: int, *, h_lo: int = 0, h_hi: int = 0,
                  itemsize: int = 4, blocks: int = 3):
    """`repro`'s three outcomes for an (n, ·) operand: ("full", None)
    while the full stripe's `blocks` buffers fit `SMEM_BUDGET_BYTES`,
    ("halo", bn) for the row-tiled kernels, ("xla", None) when no row
    tile qualifies."""
    if stripe_smem_bytes(n, itemsize=itemsize, blocks=blocks) \
            <= SMEM_BUDGET_BYTES:
        return "full", None
    bn = pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi, itemsize=itemsize,
                      blocks=blocks)
    return ("xla", None) if bn is None else ("halo", bn)


# The sparse gathers' column slab (`sparse_mix_slab_kernel`, plain, f32
# and bf16, and `sparse_mix_slab_comm_kernel`, compressed, f32; in
# csrc/mixing_matvec.cu): block s holds columns [s·c, s·c + c) of all n
# rows beside its warps' neighbor-table stage: 16 warps × 2 buffers × (16
# rows × 20 slots for 32-byte slab rows, else 32 rows × 12 slots) ×
# (index + weight).  The stage starts at the slab's size rounded up to 16
# bytes, where its 16-byte copies land aligned whatever n and c.  The
# slab row's width in bytes picks the geometry, so a bf16 slab of c
# columns is laid out as the f32 slab of c/2.
SLAB_ROW_BYTES = (32, 16, 8, 4)
SLAB_COLS = tuple(b // 4 for b in SLAB_ROW_BYTES)     # f32: 8, 4, 2, 1


def slab_cols_for(itemsize: int = 4) -> tuple[int, ...]:
    """The slab widths c, widest first, for `itemsize`-byte values:
    (8, 4, 2, 1) for f32, (16, 8, 4, 2) for bf16."""
    return tuple(b // itemsize for b in SLAB_ROW_BYTES)


def slab_smem_bytes(n: int, cols: int, itemsize: int = 4) -> int:
    """Shared memory of a slab launch: the (n, cols) slab of `itemsize`-
    byte values, rounded up to 16 bytes, and the table stage."""
    rows, slots = (16, 20) if cols * itemsize == 32 else (32, 12)
    return -(-n * cols * itemsize // 16) * 16 + 16 * 2 * rows * slots * 8


def plan_slab_cols(n: int, itemsize: int = 4) -> int | None:
    """The slab width c for a sparse gather of `itemsize`-byte values at
    n agents: the widest of `slab_cols_for(itemsize)` whose slab fits
    `SMEM_BUDGET_BYTES` (read at the call) — 8 for f32 and 16 for bf16 at
    n = 4096 (32 bytes of every row, one sector) — or None above n =
    33,536, where not even a 4-byte row fits and the row-tiled kernel
    runs."""
    for c in slab_cols_for(itemsize):
        if slab_smem_bytes(n, c, itemsize) <= SMEM_BUDGET_BYTES:
            return c
    return None


# The plain full-operand sparse gather's column stripe
# (`sparse_mix_stripe_kernel` in csrc/mixing_matvec.cu): block s holds the
# columns [s·bc, s·bc + bc) of all n rows, bc·itemsize bytes a row, and
# nothing else in shared memory.
STRIPE_ROW_BYTES = (512, 256, 128, 64, 32, 16)


def stripe_cols_for(itemsize: int = 4) -> tuple[int, ...]:
    """The stripe widths bc, widest first, for `itemsize`-byte values:
    (128, 64, 32, 16, 8, 4) for f32, (256, 128, 64, 32, 16, 8) for
    bf16."""
    return tuple(b // itemsize for b in STRIPE_ROW_BYTES)


def stripe_bytes(n: int, cols: int, itemsize: int = 4) -> int:
    """Shared memory of a stripe launch: the (n, cols) stripe of
    `itemsize`-byte values."""
    return n * cols * itemsize


def plan_stripe_cols(n: int, itemsize: int = 4) -> int | None:
    """The stripe width bc for the plain full-operand sparse gather of
    `itemsize`-byte values at n agents: the widest of
    `stripe_cols_for(itemsize)` whose stripe fits `SMEM_BUDGET_BYTES`
    (read at the call) — 128 f32 / 256 bf16 up to n = 454, 8 / 16 at n =
    4121 — or None above n = 14,528, where not even a 16-byte row fits
    and the unstaged kernel runs."""
    for c in stripe_cols_for(itemsize):
        if stripe_bytes(n, c, itemsize) <= SMEM_BUDGET_BYTES:
            return c
    return None


# The comm-fused full-operand gossips' decoded stripe
# (`sparse_mix_stripe_comm_kernel`, `circulant_mix_stripe_comm_kernel`):
# block s stages the f32 columns [s·bc, s·bc + bc) of all n rows and
# decodes them in place, and holds nothing else in shared memory.  An
# operand too narrow for one stripe per SM (`CARD_SMS`) at the widest bc
# gets narrower stripes.


def plan_comm_stripe_cols(n: int, d: int | None = None,
                          sms: int = CARD_SMS) -> int | None:
    """The decoded stripe's width bc for a comm-fused full-operand
    gossip at n agents: the widest f32 stripe that fits
    `SMEM_BUDGET_BYTES` (read at the call), `plan_stripe_cols`'s widths
    (one decoded stripe is all the kernels stage): 128 up to n = 454, 8
    at n = 4121, 4 at n = 14,528 — or None above that, where the
    unstaged kernels run.  Given the operand's width d, bc halves (down
    to 4) while ceil(d / bc) stripes leave some of the card's `sms` SMs
    without a block: 8 columns at d = 2,010 on the H100."""
    cols = plan_stripe_cols(n)
    if cols is None or d is None:
        return cols
    while cols > STRIPE_ROW_BYTES[-1] // 4 and -(-d // cols) < sms:
        cols //= 2
    return cols


# The comm-fused Neumann step's decoded stripe
# (`circulant_neumann_stripe_comm_kernel`): the comm-fused gossips' stripe
# with the Neumann update as its epilogue.  Where the operand has fewer
# 128-column tiles than the card has SMs (the n = 16 path's d2 = 2,010
# operands, its only width on the main path) the unstaged kernel keeps
# the launch, as the circulant ring's rule does (`_fills_card`): there a
# staged design's chain of copy, wait and mix loses to the unstaged
# kernel's one round of independent loads.  chip_smoke.py's kernel phase
# (H100 80GB HBM3, 700 W; device ms from torch.profiler, both routes in
# one run, bitwise the plain version and each other), stripe against
# unstaged:
#
#   (16, 2010) int4: 0.00284 (8 columns) against 0.00229;
#   (16, 2010) int8: 0.00284 against 0.00231;
#   (16, 157000) int4: 0.01895 (128 columns) against 0.03096;
#   (16, 157000) int8: 0.01908 against 0.03106;
#   (128, 157000) int4: 0.13945 against 0.22768;
#   (128, 157000) int8: 0.13964 against 0.22919;
#   (454, 157000) int8: 0.66666 against 0.78897.


def plan_neumann_comm_stripe_cols(n: int, d: int | None = None,
                                  sms: int = CARD_SMS) -> int | None:
    """The decoded stripe's width bc for the comm-fused Neumann step at
    n agents: `plan_comm_stripe_cols(n, d, sms)` (128 at (128, 157000) and
    (454, 157000)), or None, for the unstaged kernel, where that gives
    none (n > 14,528) or, given d, where the operand has fewer 128-column
    tiles than the card's `sms` SMs (d ≤ 16,768 on the H100)."""
    if not _fills_card(n, n, d, sms):
        return None
    return plan_comm_stripe_cols(n, d, sms)


def _comm_stripe(y: torch.Tensor) -> tuple[int, int]:
    """(stripe columns, shared-memory bytes) of a comm-fused full-operand
    launch on y's card; (0, 0) for the unstaged kernels."""
    n, d = y.shape
    cols = plan_comm_stripe_cols(n, d, _card_sms(y.device))
    if cols is None:
        return 0, 0
    smem = stripe_bytes(n, cols)
    assert smem <= SMEM_BUDGET_BYTES
    return cols, smem


def sparse_row_plan(neighbors, weights) -> tuple[np.ndarray, np.ndarray]:
    """The plain slab's row plan from padded (n, k) host tables: (order,
    deg), (n,) int32 each.  deg[i] counts row i's slots before its
    trailing run of padded slots — index i and weight bits exactly +0.0,
    as `structure.sparse_structure` pads — so the kernel gathers row i's
    real slots and applies the padded terms after them from registers; a
    row with no such run has deg = k.  order: the rows sorted by deg
    (stable), the order the kernel's warps walk them in."""
    nbr = np.asarray(neighbors)
    w = np.ascontiguousarray(weights, dtype=np.float32)
    if nbr.ndim != 2 or nbr.shape != w.shape:
        raise ValueError(f"neighbors and weights must both be (n, k); got "
                         f"{nbr.shape} and {w.shape}")
    n, k = nbr.shape
    pad = (nbr == np.arange(n)[:, None]) & (w.view(np.uint32) == 0)
    run = np.where(pad.all(axis=1), k, np.argmin(pad[:, ::-1], axis=1))
    deg = (k - run).astype(np.int32)
    return np.argsort(deg, kind="stable").astype(np.int32), deg


@contextlib.contextmanager
def smem_budget(nbytes: int):
    """Plan against `nbytes` of shared memory inside the block, restoring
    the budget on exit: a lower budget drives, at a small n, the routes
    the planner gives a larger one (the slab at c = 4, 2, 1, the
    row-tiled compressed gather).  Launches still check their own size
    against what a block may use."""
    global SMEM_BUDGET_BYTES
    saved, SMEM_BUDGET_BYTES = SMEM_BUDGET_BYTES, int(nbytes)
    try:
        yield
    finally:
        SMEM_BUDGET_BYTES = saved


def _halo_smem(n: int, bn, h_lo: int, h_hi: int, itemsize: int,
               blocks: int, rows: int, ring: bool = False,
               comm_ef: bool | None = None) -> tuple[int, int]:
    """Check the row tile and size the launch's shared memory: (stages,
    bytes) of `rows` staged rows — one buffer; with `ring` the staged
    circulant kernel's `halo_stages`; with `comm_ef` (False or True: EF)
    the fused circulant kernel's `halo_comm_stages` and its decoded tile
    — within what a block may use and within the plan's `blocks` buffers
    for this bn."""
    check_halo_tile(n, bn, h_lo, h_hi)
    one = halo_smem_bytes(rows, itemsize=itemsize)
    if comm_ef is not None:
        stages = halo_comm_stages(rows, ef=comm_ef)
        buffers = halo_comm_buffers(stages, ef=comm_ef)
    elif ring:
        stages = buffers = halo_stages(rows, itemsize=itemsize)
    else:
        stages = buffers = int(one <= SMEM_BUDGET_BYTES)
    if stages < 1:
        need = 1 if comm_ef is None else halo_comm_buffers(1, ef=comm_ef)
        raise ValueError(f"bn={bn}: {need} × the {rows}-row tile need "
                         f"{need * one} B of shared memory, over the "
                         f"{SMEM_BUDGET_BYTES} B a block may use "
                         f"(pick_halo_bn sizes bn)")
    smem = buffers * one
    assert smem <= halo_smem_bytes(h_lo + bn + h_hi, itemsize=itemsize,
                                   blocks=blocks)
    return stages, smem


@functools.lru_cache(maxsize=64)
def _signed_tables(n: int, offsets: tuple, weights: tuple, device):
    """The halo kernels' (k,) int32 signed offsets and (k,) f32 weights
    on `device`, built once per graph."""
    return (torch.tensor(signed_offsets(offsets, n), dtype=torch.int32,
                         device=device),
            torch.tensor(weights, dtype=torch.float32, device=device))


def circulant_mix_matvec_halo(y: torch.Tensor, zp=None, scale=None,
                              seed=None, hat=None, *, w_self: float,
                              offsets, weights, laplacian: bool = False,
                              bn: int, comm: str | None = None):
    """Row-tiled twin of `circulant_mix_matvec`: grid (n/bn, d/128), each
    block staging its rows plus the wraparound halo in shared memory.
    offsets and weights: host sequences (W[i, (i+o) mod n] = c_o, as
    `structure.offsets`/`.weights`); bn | n and halo extents ≤ bn.
    `comm` and its operands as in `circulant_mix_matvec`, a seed table
    with (n, B) zp and scale included (the job axis, counted as
    `circulant_mix_matvec_halo_comm_jobs`).  The result equals the
    full-operand kernel's bit for bit, for any bn."""
    fused = parse_kernel_comm(comm)
    _check_state("y", y)
    n, d = y.shape
    offsets = tuple(int(o) % n for o in offsets)
    weights = tuple(float(c) for c in weights)
    if len(offsets) != len(weights):
        raise ValueError(f"{len(offsets)} offsets but {len(weights)} "
                         f"weights")
    h_lo, h_hi = halo_extents(offsets, n)
    bits, ef = fused if fused is not None else (None, False)
    jobs = _check_wire(y, zp, scale, seed, hat, ef) \
        if fused is not None else 1
    # both kernels stage their tiles on a ring, the fused one beside its
    # decoded tile
    stages, smem = _halo_smem(n, bn, h_lo, h_hi, y.element_size(),
                              plan_blocks(fused is not None, ef),
                              h_lo + bn + h_hi, ring=fused is None,
                              comm_ef=None if fused is None else ef)
    kw = dict(w_self=float(w_self), offsets=offsets, weights=weights,
              laplacian=laplacian, bn=bn)
    if y.device.type == "cpu":
        if fused is None:
            return circulant_mix_halo_ref(y.float(), **kw).to(y.dtype)
        return circulant_mix_halo_ref(y, zp, scale, seed, hat, bits=bits,
                                      **kw)
    soff, w = _signed_tables(n, offsets, weights, y.device)
    out = torch.empty_like(y)
    geometry = (len(offsets), soff.data_ptr(), w.data_ptr(),
                int(bool(laplacian)), bn, h_lo, h_hi)
    if fused is None:
        _launch("circulant_mix_halo", "circulant_mix_matvec_halo", y.device,
                y.data_ptr(), out.data_ptr(), n, d, _DTYPE_CODE[y.dtype],
                float(w_self), *geometry, stages, smem)
        return out
    pay = torch.empty_like(y) if ef else None
    head = (y.data_ptr(), out.data_ptr(), _ptr(pay), _ptr(hat),
            zp.data_ptr(), scale.data_ptr())
    tail = (float(2 ** bits - 1), n, d, float(w_self), *geometry, stages,
            smem)
    if is_seed_table(seed):
        table = _seed_table(seed)
        _launch("circulant_mix_halo_comm_jobs",
                "circulant_mix_matvec_halo_comm_jobs", y.device, *head,
                ctypes.addressof(table), jobs, d // jobs, *tail)
    else:
        _launch("circulant_mix_halo_comm", "circulant_mix_matvec_halo_comm",
                y.device, *head, seed & 0xFFFFFFFF, *tail)
    return (out, pay) if ef else out


def sparse_mix_matvec_halo(y: torch.Tensor, w_self: torch.Tensor,
                           neighbors: torch.Tensor, weights: torch.Tensor,
                           zp=None, scale=None, seed=None, *,
                           laplacian: bool = False, bn: int,
                           comm: str | None = None,
                           row_plan=None) -> torch.Tensor:
    """Halo-tier twin of `sparse_mix_matvec` for large n.  Tables as in
    `sparse_mix_matvec`; bn | n.  ``comm="int8" | "int4"`` fuses the
    quantizer; error feedback is refused, as `repro` refuses it (no
    payload write-back here).

    The planner chooses the kernel by shape: where a column slab fits
    (`plan_slab_cols`, n ≤ 33,536 in f32) a slab kernel runs, which holds
    c columns of every row in shared memory and gathers every neighbor
    from there, whatever bn (with ``comm`` it decodes each element once);
    above that the row-tiled kernel, grid (n/bn, d/128), each block
    staging its own rows and gathering neighbor rows from device memory
    (with ``comm`` decoding each neighbor value where it is gathered, k
    hashes per element).  The two routes count apart:
    `sparse_mix_matvec_halo[_comm]` the slab, `..._rows` the row tiles.
    With ``comm`` a seed table and (n, B) zp and scale run the job axis
    on either route, counted with `_jobs`.

    row_plan: (order, deg), (n,) int32 each on y's device, from
    `sparse_row_plan` on the same tables (plain gather only).  The plain
    slab then walks the rows in `order`, a warp gathering its rows' slots
    up to the most real slots among them and applying the padded slots
    (i, +0.0) past that from registers; without it, rows go in natural
    order and every slot is gathered.  The row-tiled kernel takes no
    plan.  A
    plan from other tables gives wrong sums (it is not checked on the
    card: that would synchronize).  bn keeps `repro`'s meaning and checks
    on every route, and every route's output equals the full-operand
    kernel's bit for bit."""
    fused = parse_kernel_comm(comm)
    if fused is not None and fused[1]:
        raise ValueError("the sparse halo kernel does not lower '+ef' "
                         "comm; use the full-operand kernel or compose "
                         "the compressor with the plain mix")
    if fused is not None and row_plan is not None:
        raise ValueError("row_plan drives the plain gather; the compressed "
                         "slab walks rows in natural order")
    _check_state("y", y)
    n, d = y.shape
    k = neighbors.shape[1] if neighbors.dim() == 2 else -1
    _check_table("w_self", w_self, (n,), torch.float32, y.device)
    _check_table("neighbors", neighbors, (n, k), torch.int32, y.device)
    _check_table("weights", weights, (n, k), torch.float32, y.device)
    if row_plan is not None:
        order, deg = row_plan
        _check_table("row_plan order", order, (n,), torch.int32, y.device)
        _check_table("row_plan deg", deg, (n,), torch.int32, y.device)
    jobs = _check_wire(y, zp, scale, seed, None, False) \
        if fused is not None else 1
    _, smem = _halo_smem(n, bn, 0, 0, y.element_size(),
                         plan_blocks(fused is not None), bn)
    if y.device.type == "cpu":
        if fused is None:
            return sparse_mix_halo_ref(y.float(), w_self, neighbors,
                                       weights, laplacian=laplacian,
                                       bn=bn).to(y.dtype)
        return sparse_mix_halo_ref(y, w_self, neighbors, weights, zp, scale,
                                   seed, laplacian=laplacian, bn=bn,
                                   bits=fused[0])
    out = torch.empty_like(y)
    tables = (w_self.data_ptr(), neighbors.data_ptr(), weights.data_ptr())
    cols = plan_slab_cols(n, y.element_size())
    if cols is not None:
        smem = slab_smem_bytes(n, cols, y.element_size())
    if fused is None:
        plan = (None, None) if row_plan is None or cols is None \
            else (order.data_ptr(), deg.data_ptr())
        _launch("sparse_mix_halo", "sparse_mix_matvec_halo"
                if cols is not None else "sparse_mix_matvec_halo_rows",
                y.device, y.data_ptr(), out.data_ptr(), *tables, *plan, n,
                d, k, _DTYPE_CODE[y.dtype], int(bool(laplacian)), bn,
                cols or 0, smem)
        return out
    counter = "sparse_mix_matvec_halo_comm" if cols is not None \
        else "sparse_mix_matvec_halo_comm_rows"
    head = (y.data_ptr(), out.data_ptr(), zp.data_ptr(), scale.data_ptr())
    tail = (float(2 ** fused[0] - 1), *tables, n, d, k,
            int(bool(laplacian)), bn, cols or 0, smem)
    if is_seed_table(seed):
        table = _seed_table(seed)
        _launch("sparse_mix_halo_comm_jobs", counter + "_jobs", y.device,
                *head, ctypes.addressof(table), jobs, d // jobs, *tail)
    else:
        _launch("sparse_mix_halo_comm", counter, y.device, *head,
                seed & 0xFFFFFFFF, *tail)
    return out
