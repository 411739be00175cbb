"""Cells small enough for the CPU tests: the port's reduced configs
written as the benchmark's configuration files would be, and a traffic
mix of a few short rows."""
from __future__ import annotations

import dataclasses

from benchlib.cell import Cell

TRAFFIC = {"batch": 2, "seq": 80, "episode_median": 20, "episode_sigma": 1.0,
           "close_after": 4, "gamma": 0.99, "step_reward_std": 0.1,
           "logprob_std": 0.5, "pool": 6}
LIMITS = {"loss": 0.01, "grad": 0.1, "change": 0.1}


def config(arch: str, dtype: str = "bfloat16") -> dict:
    """The port's reduced ``arch`` as a configuration file's dict."""
    from repro_torch.configs.base import get_config
    c = get_config(arch).reduced()
    out = {"port": {"arch": arch, "reduced": True, "dtype": dtype},
           "num_hidden_layers": c.n_layers, "hidden_size": c.d_model,
           "intermediate_size": c.d_ff, "vocab_size": c.vocab_size,
           "norm_epsilon": 1e-6, "torch_dtype": dtype}
    if arch == "starcoder2-3b":
        out.update(architecture="starcoder2", num_attention_heads=c.n_heads,
                   num_key_value_heads=c.n_kv_heads,
                   head_dim=c.resolved_head_dim, rope_theta=c.rope_theta)
    else:
        from repro_torch.models.rwkv6 import DECAY_RANK
        out.update(architecture="rwkv6", head_size=c.resolved_head_dim,
                   decay_lora_rank=DECAY_RANK, head_norm_epsilon=1e-6)
    return out


def cell(arch: str, warmup: int = 4, limits=None) -> Cell:
    return Cell(name=f"{arch}.tiny", cfg=config(arch), traffic=dict(TRAFFIC),
                spec={"config": arch, "traffic": "tiny", "lr": 1e-3,
                      "warmup_steps": warmup,
                      "limits": dict(limits or LIMITS)},
                end_to_end=["train_tokens_per_s", "peak_mem_gib", "setup_s"],
                per_layer=[])


def port_config(arch: str, dtype: str):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               use_pallas_attention=True)
