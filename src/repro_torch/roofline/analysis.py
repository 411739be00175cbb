"""Three-term roofline of one step on the H100 constants.

Counterpart of ``repro/roofline/analysis.py``:

  compute term    = FLOPs_per_rank / PEAK_FLOPS_BF16
  memory term     = bytes_per_rank / HBM_BW
  collective term = model-axis collective bytes / NVLINK_BW
                    + data/pod-axis collective bytes / IB_BW

The reference's one ``ICI_BW`` maps onto the H100's two links: the
``model`` axis is one NVLink node, the ``data`` and ``pod`` axes cross
InfiniBand. The counts come from ``roofline/op_cost.py``, which reads
the collectives as eager ops, so ``parse_collectives`` (the HLO
while-loop walk) has no counterpart. ``count_params`` and
``model_flops_for`` are the reference's, unchanged.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6 * N_active * tokens, global
    useful_flops_ratio: float     # model_flops / (counted flops * chips)
    peak_memory_per_chip: float
    collective_detail: Dict[str, float] = field(default_factory=dict)
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def build_roofline(arch, shape, mesh_name, chips, cost, collectives,
                   model_flops, peak_memory) -> Roofline:
    """``cost``: {"flops", "bytes accessed"} per rank; ``collectives``:
    {"bytes_by_op": {...}, "nvlink_bytes": b, "ib_bytes": b} per rank."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    nvl = float(collectives.get("nvlink_bytes", 0.0))
    ib = float(collectives.get("ib_bytes", 0.0))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    coll_s = nvl / NVLINK_BW + ib / IB_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    ratio = model_flops / max(flops * chips, 1.0)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=byts,
        collective_bytes_per_chip=nvl + ib, compute_s=compute_s,
        memory_s=memory_s, collective_s=coll_s, bottleneck=bottleneck,
        model_flops=model_flops, useful_flops_ratio=ratio,
        peak_memory_per_chip=peak_memory,
        collective_detail=dict(collectives.get("bytes_by_op", {})),
    )


def count_params(cfg) -> float:
    """Total and active parameter counts (analytic, from the config)."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    dh = cfg.resolved_head_dim
    attn = D * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    gate = 1 if cfg.mlp_kind != "swiglu" else 2
    mlp_dense = D * F * (gate + 1)
    total = active = 0.0
    for (mixer, ffn) in cfg.layer_kinds:
        if mixer in ("attn_full", "attn_local"):
            total += attn
            active += attn
        elif mixer == "rglru":
            total += 6 * D * D
            active += 6 * D * D
        elif mixer == "rwkv":
            total += 5 * D * D + D * D
            active += 5 * D * D + D * D
        if ffn == "moe":
            e_mlp = D * cfg.d_ff * 3
            total += cfg.n_experts * e_mlp + D * cfg.n_experts
            active += cfg.top_k * e_mlp + D * cfg.n_experts
            if cfg.shared_expert:
                total += e_mlp
                active += e_mlp
        else:
            total += mlp_dense
            active += mlp_dense
    emb = V * D
    total += emb * 2          # embed + untied lm head
    active += emb * 2
    if cfg.is_encoder_decoder:
        enc = cfg.n_enc_layers * (attn + mlp_dense)
        xattn = cfg.n_layers * attn
        total += enc + xattn
        active += enc + xattn
    return total, active


def model_flops_for(cfg, shape_kind: str, seq_len: int, batch: int) -> float:
    """6*N_active*tokens for training; 2*N_active*tokens for inference
    forward (prefill); decode: 2*N_active per token * batch."""
    _, active = count_params(cfg)
    if shape_kind == "train":
        return 6.0 * active * seq_len * batch
    if shape_kind == "prefill":
        return 2.0 * active * seq_len * batch
    return 2.0 * active * batch       # one decoded token per request


def mfu(model_flops: float, seconds: float, chips: int = 1) -> float:
    """The share of the ranks' dense BF16 peak that ``model_flops`` in
    ``seconds`` is."""
    return model_flops / (seconds * chips * PEAK_FLOPS_BF16)
