"""Architecture + input-shape configuration system.

Every assigned architecture gets one `ArchConfig` (exact numbers from the
assignment, source cited in `citation`).  `reduced()` produces the CPU
smoke variant (2 layers, d_model ≤ 512, ≤ 4 experts).  Input shapes are
the four assigned workload shapes; `repro_torch.data.lm_batch_spec`
turns one into meta-device stand-ins.

Counterpart of `repro.configs.base`: the same plain dataclasses, fields,
defaults and derived properties, copied (the port imports nothing of
`repro`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "vlm", "audio", "hybrid"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    citation: str
    num_layers: int
    d_model: int
    num_heads: int          # 0 for attention-free architectures
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 → d_model // num_heads
    qk_norm: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention variants
    sliding_window: int = 0          # 0 → full attention
    long_context_window: int = 8192  # SWA window used for the long_500k
    #                                  decode variant of full-attn archs
    # SSM / linear attention
    attn_free: bool = False          # rwkv6: no attention anywhere
    rwkv_head_size: int = 64
    ssm_state: int = 0               # mamba2 state size (zamba2)
    mamba_head_dim: int = 64
    conv_kernel: int = 4
    # hybrid (zamba2): mamba backbone + shared attention block every k
    shared_attn_every: int = 0
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500       # stub frontend output length
    # MoE routing layout: 0/1 = single global routing domain (the
    # faithful default); G > 1 = group-local routing (each of G token
    # groups routes + dispatches independently, so dispatch buffers and
    # the routing sort shard over the data axis — EXPERIMENTS.md §Perf)
    moe_route_groups: int = 0
    # grouped-dispatch implementation: "batched" (sort/scatter with a
    # leading group axis + sharding constraints; differentiates through
    # grad-accumulation scans) or "shard_map" (guaranteed shard-local,
    # best HLO, but trips an XLA check-failure under grad+scan on the
    # CPU backend — used for serving paths).  See EXPERIMENTS §Perf-1/2.
    moe_group_impl: str = "batched"
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return self.rwkv_head_size

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way
        model parallelism (see DESIGN.md §5)."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def block_kinds(self) -> list[str]:
        """Per-layer mixer kinds for the decoder stack."""
        if self.attn_free:
            return ["rwkv6"] * self.num_layers
        if self.shared_attn_every:
            return ["mamba2"] * self.num_layers   # shared attn handled
        #                                           separately (zamba2)
        return ["attn"] * self.num_layers

    def shared_attn_positions(self) -> list[int]:
        if not self.shared_attn_every:
            return []
        k = self.shared_attn_every
        return [i for i in range(self.num_layers) if i % k == k - 1]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_p = self.padded_vocab * d                     # embedding
        if not self.tie_embeddings:
            n_p += self.padded_vocab * d                # lm head
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per_mlp = 3 * d * self.d_ff                     # SwiGLU
        per_moe = self.num_experts * 3 * d * self.d_ff \
            + d * self.num_experts                      # experts + router
        per_rwkv = 5 * d * d + 2 * 32 * d               # r,k,v,g,o + loras
        nheads_m = 0
        if self.ssm_state:
            d_inner = 2 * d
            nheads_m = d_inner // self.mamba_head_dim
            per_mamba = d * (2 * d_inner + 2 * self.ssm_state * nheads_m
                             + nheads_m) + d_inner * d
        for i, kind in enumerate(self.block_kinds()):
            n_p += 2 * d                                # norms
            if kind == "attn":
                n_p += per_attn + per_mlp
            elif kind == "rwkv6":
                n_p += per_rwkv + 2 * d * self.d_ff     # rwkv channel-mix
            elif kind == "mamba2":
                n_p += per_mamba
        if self.shared_attn_every:
            n_p += per_attn + 3 * d * self.d_ff         # one shared block
            n_p += len(self.shared_attn_positions()) * d * d  # projectors
        if self.num_experts:
            # blocks above counted dense mlp; swap for moe
            n_p += self.num_layers * (per_moe - per_mlp)
        if self.encoder_decoder:
            n_p += self.encoder_layers * (per_attn + per_mlp + 2 * d)
            n_p += self.num_layers * (per_attn + d)     # cross-attn
        return n_p

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense_moe = self.num_layers * self.num_experts * 3 * d * self.d_ff
        active_moe = self.num_layers * self.top_k * 3 * d * self.d_ff
        return self.param_count() - dense_moe + active_moe

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant: 2 layers, d_model ≤ 512, ≤ 4 experts —
        same family/features, tiny dims."""
        d = min(self.d_model, 256)
        heads = 0 if self.attn_free else min(self.num_heads, 4) or 4
        kv = 0 if self.attn_free else max(1, min(self.num_kv_heads, heads))
        hd = d // heads if heads else 32
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd if not self.attn_free else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            rwkv_head_size=32,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            mamba_head_dim=32,
            shared_attn_every=self.shared_attn_every and 2,
            encoder_layers=2 if self.encoder_decoder else 0,
            encoder_frames=16 if self.encoder_decoder else self.encoder_frames,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
