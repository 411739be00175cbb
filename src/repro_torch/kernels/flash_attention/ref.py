"""Plain PyTorch version of the flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/ref.py``: naive
materialized attention, fp32 scores, a finite ``NEG_INF`` and ``kv_len``
masking. Layout matches the kernel: q (B, H, Sq, Dh); k, v
(B, KV, Sk, Dh); query head h uses kv head h // (H // KV).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, kv_len=None):
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    R = H // KV
    kr = k.repeat_interleave(R, dim=1).float()
    vr = v.repeat_interleave(R, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * Dh ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
