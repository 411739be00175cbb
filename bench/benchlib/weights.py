"""Random weights from the run's seed, made on the device in a few large
calls: one normal draw per stored dtype into one flat buffer, each
parameter a view of it scaled to its spec; constants filled. The same
seed on the same kind of device gives the same bits, so the program and
the reference are handed the same weights, each made here."""
from __future__ import annotations

from typing import Dict

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed`` (any whole
    number; reduced to 64 bits)."""
    mixed = (int(seed) * 1_000_003 + stream) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


@torch.no_grad()
def make(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``specs`` ((name, shape, dtype, init) as
    ``reference.model.param_specs`` gives them)."""
    out: Dict[str, torch.Tensor] = {}
    normal = {}
    for name, shape, dtype, init in specs:
        if init[0] == "normal":
            normal.setdefault(dtype, []).append((name, shape, init[1]))
        else:
            out[name] = torch.full(shape, init[1], dtype=dtype,
                                   device=device)
    for i, (dtype, leaves) in enumerate(sorted(normal.items(),
                                               key=lambda kv: str(kv[0]))):
        total = sum(_numel(shape) for _, shape, _ in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        flat.normal_(generator=generator(seed, i, device))
        offset = 0
        for name, shape, std in leaves:
            n = _numel(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(std)
            offset += n
    return {name: out[name] for name, *_ in specs}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
