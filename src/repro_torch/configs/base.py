"""Model / architecture configuration: the port's own copy of
``repro/configs/base.py`` (the port imports nothing of ``repro``).

Fields, defaults and ``reduced()`` are kept identical to the reference so
a config means the same thing on both sides of the bridge. The port
registers every architecture the reference registers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Layer mixer kinds.
ATTN_FULL = "attn_full"      # full causal (or bidirectional for encoders)
ATTN_LOCAL = "attn_local"    # sliding-window causal
RGLRU = "rglru"              # RecurrentGemma RG-LRU recurrent block
RWKV = "rwkv"                # RWKV-6 time-mix

# FFN kinds.
FFN_DENSE = "dense"
FFN_MOE = "moe"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # Layer pattern: cycle of (mixer, ffn) kinds, tiled over n_layers.
    mixer_cycle: Tuple[str, ...] = (ATTN_FULL,)
    ffn_cycle: Tuple[str, ...] = (FFN_DENSE,)

    # Attention options.
    window: int = 4096                # sliding window for ATTN_LOCAL
    attn_softcap: float = 0.0         # gemma2-style attention logit softcap
    final_softcap: float = 0.0        # gemma2-style final logit softcap
    rope_theta: float = 10_000.0
    mrope: bool = False               # Qwen2-VL multimodal RoPE (3 position streams)
    rope_on_global: bool = True       # llama4 iRoPE: NoPE on global layers

    # MoE options.
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False       # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    moe_group_size: int = 128         # tokens per dispatch group (GShard-style)
    router_aux_weight: float = 0.01
    # "capacity" = GShard einsum dispatch (baseline); "dropless" =
    # sort + ragged_dot under shard_map (beyond-paper, §Perf)
    moe_impl: str = "capacity"
    # cast dense-MLP weight gradients to bf16 before the data-axis
    # all-reduce (halves gradient comm; beyond-paper, §Perf)
    grad_comm_bf16: bool = False

    # Recurrent options (RG-LRU / RWKV).
    conv_width: int = 4               # temporal conv in Griffin recurrent block
    rglru_c: float = 8.0

    # Encoder-decoder (audio).
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0                  # precomputed frame embeddings length

    # VLM frontend stub.
    vision_prefix: int = 0            # patch embeddings merged at sequence start

    # Serving: local-attention layers keep a ring cache of ``window``
    # entries instead of the full sequence (beyond-paper optimization;
    # see EXPERIMENTS.md §Perf).
    ring_cache: bool = True
    # Tensor-parallel attention layout: materialize the GQA repeat so
    # q/k/v all carry the full head count (divisible by the model axis)
    # and attention runs head-parallel with zero collectives. Costs a
    # R-fold larger (sharded) k/v activation; wins when kv_heads doesn't
    # divide the model axis (beyond-paper optimization, §Perf).
    attn_tp_repeat: bool = False
    # Attention compute replicated over the model axis (batch-sharded
    # only). For head counts indivisible by the axis (llama4's 40),
    # head_dim-sharding all-reduces every score tile; replicating trades
    # bounded redundant FLOPs for zero attention collectives (§Perf).
    attn_replicate_tp: bool = False
    # Use the hand-written kernels for forward passes where no gradient is
    # needed (prefill/serve): flash attention, and the lru_scan and wkv6
    # recurrences, which the reference runs only as plain code in its
    # models. False asks for the plain versions on the card; CPU tensors
    # always take them. The name is the reference's, kept so configs line
    # up across the bridge.
    use_pallas_attention: bool = False

    # Misc.
    mlp_kind: str = "swiglu"          # swiglu | gelu
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Whether the arch supports the long_500k decode shape (sub-quadratic or
    # sliding-window attention on all/most layers). Full-attention archs skip.
    sub_quadratic: bool = False
    source: str = ""                  # citation for the config numbers

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) for every layer, tiling the cycles."""
        out = []
        for i in range(self.n_layers):
            out.append((self.mixer_cycle[i % len(self.mixer_cycle)],
                        self.ffn_cycle[i % len(self.ffn_cycle)]))
        return tuple(out)

    @property
    def cycle_len(self) -> int:
        import math
        return math.lcm(len(self.mixer_cycle), len(self.ffn_cycle))

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/mixers, tiny dims."""
        n_layers = min(self.n_layers, max(2, len(self.mixer_cycle)))
        # keep at least one full cycle so every mixer kind is exercised,
        # capped at 4 layers.
        n_layers = min(max(n_layers, len(self.mixer_cycle)), 4)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = min(self.resolved_head_dim, 64)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 64),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 32),
            vision_prefix=min(self.vision_prefix, 8),
            moe_group_size=16,
            # no capacity drops at toy scale so prefill+decode is exactly
            # consistent with the full forward (capacity-based MoE drops
            # depend on group boundaries, which differ between the two paths)
            capacity_factor=4.0,
        )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    # import side-effect registers every config module in this package
    from repro_torch.configs import (  # noqa: F401
        gemma2_27b, granite_moe_1b_a400m, h2o_danube_3_4b,
        llama4_scout_17b_a16e, qwen2_vl_72b, recurrentgemma_9b, rwkv6_7b,
        stablelm_12b, starcoder2_3b, whisper_medium)
