"""Executor-owned randomness: threefry2x32 keys and the Gumbel-argmax
sampler, bit-compatible with ``jax.random``.

Counterpart of ``repro/core/determinism.py``. The determinism contract
makes every sampled action a pure function of (seed, env_id or request,
step), so the port carries its own threefry2x32 instead of a
``torch.Generator``. A key is an int64 tensor of shape (..., 2) holding
two uint32 words; every word is kept in [0, 2**32) by masking, so int64
arithmetic never overflows.

Recipe (jax 0.9, ``jax_threefry_partitionable=True``):
  key(seed)      = [seed >> 32, seed & 0xFFFFFFFF]
  fold_in(k, d)  = threefry(k, (0, d))
  bits(k, shape) = x0 ^ x1 of threefry(k, (iota >> 32, iota & mask)),
                   iota the row-major index over ``shape``
  uniform        = bitcast((bits >> 9) | 0x3F800000) - 1, then
                   max(tiny, u * (1 - tiny) + tiny)
  gumbel         = -log(-log(uniform))
  categorical    = argmax(logits + gumbel)
Integer bits and uniforms match jax exactly; the two ``log``s may differ
from XLA's by an ulp or two, so an action can differ only where two
perturbed logits tie to within that.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on int64 tensors of uint32 values
    (broadcasting). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _as_words(x, device=None):
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def master_key(run_seed: int, device=None):
    seed = int(run_seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(key, data):
    """key (..., 2); data int or int tensor broadcastable to key[..., 0]."""
    d = _as_words(data, key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def obs_key(master, env_id, step):
    """Key for the action sampled for (env_id, step)."""
    return fold_in(fold_in(master, env_id), step)


def obs_keys(master, env_ids, step):
    """Vectorized: env_ids (n,) -> keys (n, 2)."""
    return obs_key(master, _as_words(env_ids, master.device), step)


def request_key(master, request_seed):
    """Key for one serving request: a pure function of (seed, request)."""
    return fold_in(master, request_seed)


def random_bits(key, shape):
    """uint32 bits (as int64) of shape key.shape[:-1] + shape: each key
    draws over ``shape`` on its own, as ``jax.vmap`` of
    ``jax.random.bits`` over a batch of keys does."""
    n = 1
    for s in shape:
        n *= s
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    y1, y2 = threefry2x32(k1, k2, iota >> 32, iota & MASK)
    return y1 ^ y2


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """fp32 uniforms in [minval, maxval), bit-exact with jax.random."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape):
    """jax.random.gumbel in its default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def sample_action(key, logits):
    """Categorical sample: argmax(logits + gumbel). ``key`` (..., 2) with
    batch dims matching the leading dims of ``logits``; each key samples
    over the remaining dims, as ``jax.vmap`` of
    ``jax.random.categorical`` does. A single key (2,) samples over all of
    ``logits``, as ``jax.random.categorical(key, logits)`` does."""
    nb = key.dim() - 1
    g = gumbel(key, tuple(logits.shape[nb:]))
    return torch.argmax(logits.float() + g, dim=-1)
