"""The paper's own policy network (Atari / GFootball CNN).

Counterpart of ``repro/configs/paper_cnn.py``, same widths: conv
32x8x8/4, conv 64x4x4/2, conv 64x3x3/1, fc 512, then policy and value
heads, on (84, 84, 4) observations with 18 actions.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNPolicyConfig:
    name: str = "paper-cnn"
    obs_shape: Tuple[int, int, int] = (84, 84, 4)
    conv_filters: Tuple[int, ...] = (32, 64, 64)
    conv_sizes: Tuple[int, ...] = (8, 4, 3)
    conv_strides: Tuple[int, ...] = (4, 2, 1)
    hidden: int = 512
    n_actions: int = 18


CONFIG = CNNPolicyConfig()
