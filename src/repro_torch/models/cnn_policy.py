"""The paper's policy network (appendix F) and the small policies.

Counterpart of ``repro/models/cnn_policy.py``. Params are flat dicts of
tensors (names as the reference's), so ``torch.func`` differentiates
them. Observations come in the reference's layout, (B, H, W, C) for the
CNN; conv kernels are stored OIHW and ``apply_cnn`` runs its convs in
NCHW, turning back to NHWC before the flatten so that ``fc_w`` keeps the
reference's row order. Init draws the reference's normals in the
reference's shapes (HWIO for conv kernels) from the same keys.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNPolicyConfig
from repro_torch.core import determinism


def _conv_out(n, k, s):
    return (n - k) // s + 1


def _zeros(n: int, key):
    return torch.zeros((n,), dtype=torch.float32, device=key.device)


def init_cnn(key, cfg: CNNPolicyConfig, n_actions: int,
             obs_shape: Tuple[int, ...]):
    ks = determinism.split(key, 8)
    h, w, cin = obs_shape
    params = {}
    for i, (f, k, s) in enumerate(zip(cfg.conv_filters, cfg.conv_sizes,
                                      cfg.conv_strides)):
        fan_in = k * k * cin
        hwio = determinism.normal(ks[i], (k, k, cin, f)) \
            * math.sqrt(2.0 / fan_in)
        params[f"conv{i}_w"] = hwio.permute(3, 2, 0, 1).contiguous()
        params[f"conv{i}_b"] = _zeros(f, key)
        h, w, cin = _conv_out(h, k, s), _conv_out(w, k, s), f
    flat = h * w * cin
    params["fc_w"] = determinism.normal(ks[5], (flat, cfg.hidden)) \
        * math.sqrt(2.0 / flat)
    params["fc_b"] = _zeros(cfg.hidden, key)
    params["pi_w"] = determinism.normal(ks[6], (cfg.hidden, n_actions)) * 0.01
    params["pi_b"] = _zeros(n_actions, key)
    params["v_w"] = determinism.normal(ks[7], (cfg.hidden, 1)) * 1.0
    params["v_b"] = _zeros(1, key)
    return params


def apply_cnn(params, obs, cfg: CNNPolicyConfig):
    """obs: (B, H, W, C) -> (logits (B, A), value (B,))."""
    x = obs.to(torch.float32).permute(0, 3, 1, 2)
    for i, s in enumerate(cfg.conv_strides):
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=s))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc_w"] + params["fc_b"])
    logits = x @ params["pi_w"] + params["pi_b"]
    value = (x @ params["v_w"] + params["v_b"])[:, 0]
    return logits, value


def init_mlp_policy(key, obs_dim: int, n_actions: int, hidden: int = 128):
    ks = determinism.split(key, 4)
    return {
        "w1": determinism.normal(ks[0], (obs_dim, hidden))
        * math.sqrt(2.0 / obs_dim),
        "b1": _zeros(hidden, key),
        "w2": determinism.normal(ks[1], (hidden, hidden))
        * math.sqrt(2.0 / hidden),
        "b2": _zeros(hidden, key),
        "pi_w": determinism.normal(ks[2], (hidden, n_actions)) * 0.01,
        "pi_b": _zeros(n_actions, key),
        "v_w": determinism.normal(ks[3], (hidden, 1)),
        "v_b": _zeros(1, key),
    }


def apply_mlp_policy(params, obs):
    x = obs.to(torch.float32)
    if x.dim() == 1:
        x = x[None]
    x = torch.tanh(x @ params["w1"] + params["b1"])
    x = torch.tanh(x @ params["w2"] + params["b2"])
    logits = x @ params["pi_w"] + params["pi_b"]
    value = (x @ params["v_w"] + params["v_b"])[:, 0]
    return logits, value


def init_token_policy(key, vocab: int, hidden: int = 128):
    ks = determinism.split(key, 3)
    return {
        "embed": determinism.normal(ks[0], (vocab, hidden)) * 0.1,
        "w": determinism.normal(ks[1], (hidden, hidden))
        * math.sqrt(2.0 / hidden),
        "b": _zeros(hidden, key),
        "pi_w": determinism.normal(ks[2], (hidden, vocab)) * 0.01,
        "pi_b": _zeros(vocab, key),
        "v_w": torch.zeros((hidden, 1), dtype=torch.float32,
                           device=key.device),
        "v_b": _zeros(1, key),
    }


def apply_token_policy(params, obs):
    """obs: (B,) int32 tokens."""
    x = params["embed"][obs.long()]
    x = torch.tanh(x @ params["w"] + params["b"])
    logits = x @ params["pi_w"] + params["pi_b"]
    value = (x @ params["v_w"] + params["v_b"])[:, 0]
    return logits, value
