"""repro_torch — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

The package mirrors `repro`'s module layout and public names, so each
counterpart sits where a reader of the JAX package expects it:

  * `topology`  — graphs, mixing weights, structure extraction and the
                  `MixingOp` gossip executor,
  * `kernels`   — hand-written CUDA kernels for the gossip mat-vecs
                  (`kernels/csrc/`), their plain PyTorch versions
                  (`kernels.ref`) and the wrappers that dispatch between
                  them,
  * `comm`      — the identity gossip wire and its byte ledger,
  * `core`      — the bilevel problem zoo, penalty/DIHGP/DAGM algebra
                  and the paper's baselines (DGBO, DGTBO, FedNest,
                  MA-DBO),
  * `faults`    — fault injection: `FaultSpec`, lowered to per-round
                  edge masks (`lower_faults`, `FaultTrace`),
  * `solve`     — the `solve(problem, network, spec)` front-end
                  (every method on tier="reference"; dagm on
                  tier="serve" and tier="sharded"),
  * `distributed` — the sharded tier: ring collectives and the sharded
                  DAGM on one device's agent ring (`LocalRing`) or a
                  `torch.distributed` process ring (`ProcessRing`),
  * `optim`     — SGD, AdamW, clipping and step-size schedules,
  * `serve`     — the batched multi-job engine (`ServeEngine`): buckets
                  of jobs gossiping on the kernels' job axis,
  * `obs`       — spans, metrics, export and the flight recorder,
  * `checkpoint` — tensor trees to atomic .npz steps (`repro`'s layout),
  * `configs`   — the LM workload's architectures (`ArchConfig`),
  * `data`      — its synthetic token pipeline,
  * `models`    — its model zoo: serving (prefill, decode, greedy
                  sampling; self-attention and the RWKV mix on the
                  attention and WKV-scan kernels) and the training step,
  * `launch`    — device meshes for it (`distributed.sharding` maps its
                  logical axes onto them), its cost model, training
                  launcher and dry runs, and the decentralized bilevel LM
                  round,
  * `interop`   — builds port objects from `repro`'s numpy arrays.

The port imports `torch` only.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; without a card they raise
instead of falling back (`repro_torch.resolve_device`), and they keep
float32 matmuls out of TF32 inside `strict_f32`, which restores the
caller's flags on exit.
"""
from ._device import resolve_device, strict_f32

__all__ = ["resolve_device", "strict_f32"]
