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
  split(k, n)    = both words of threefry(k, (iota >> 32, iota & mask))
  permutation    = rounds of split, 32 bits per element, stable sort
  randint        = two bit draws from split(k, 2), combined with the span
                   multiplier 2**32 % span (``jax.random.randint``)
  normal         = sqrt(2) * erfinv(uniform in (nextafter(-1, 0), 1))
Integer bits and uniforms match jax exactly; the two ``log``s may differ
from XLA's by an ulp or two, so an action can differ only where two
perturbed logits tie to within that. ``normal`` evaluates XLA's own
erfinv polynomial, and differs from XLA by a few ulp in the same way.
"""
from __future__ import annotations

import numpy as np
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


def _iota_words(shape, device):
    """The row-major index over ``shape`` as its (high, low) uint32 words."""
    n = 1
    for s in shape:
        n *= s
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & MASK


def _key_words(key, ndim: int):
    """The two words of ``key`` (..., 2), shaped to broadcast against
    ``ndim`` trailing draw dims."""
    lead = key.shape[:-1]
    return (key[..., 0].reshape(lead + (1,) * ndim),
            key[..., 1].reshape(lead + (1,) * ndim))


def split(key, num: int = 2):
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    k1, k2 = _key_words(key, 1)
    hi, lo = _iota_words((num,), key.device)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack((y1, y2), dim=-1)


def random_bits(key, shape):
    """uint32 bits (as int64) of shape key.shape[:-1] + shape: each key
    draws over ``shape`` on its own, as ``jax.vmap`` of
    ``jax.random.bits`` over a batch of keys does."""
    k1, k2 = _key_words(key, len(shape))
    hi, lo = _iota_words(tuple(shape), key.device)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return y1 ^ y2


def randint(key, shape, minval: int, maxval: int):
    """int32 draws in [minval, maxval), bit-exact with
    ``jax.random.randint``: the high and low words come from the two
    halves of ``split(key)`` and are combined modulo the span through
    ``2**32 % span``, in uint32 arithmetic. A single word taken modulo the
    span would give other values for some keys. As in jax, that multiplier
    is (2**16 % span)**2 in uint32, which wraps to 0 for spans above 2**16:
    there only the low word counts."""
    lo_i, hi_i = -2 ** 31, 2 ** 31 - 1
    if not (lo_i <= minval <= hi_i and lo_i <= maxval <= hi_i):
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside int32")
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = (((higher % span) * mult) & MASK) + lower % span
    off = (off & MASK) % span
    return (minval + off).to(torch.int32)


def permutation(key, x):
    """``jax.random.permutation(key, x)`` for an int ``x`` (a shuffled
    ``arange(x)``) or a 1-D tensor, bit-exact: ceil(3 ln n / ln(2**32 -
    1)) rounds, each splitting the key, drawing 32 bits per element and
    sorting by them stably (``lax.sort_key_val``). Keys tie a few times
    per round at large n, so the sort must be stable."""
    if isinstance(x, int):
        x = torch.arange(x, dtype=torch.int32, device=key.device)
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """fp32 uniforms in [minval, maxval), bit-exact with jax.random."""
    bits = random_bits(key, shape)
    # jax's float of the top 23 bits, (0x3F800000 | m) as float minus 1,
    # is m * 2^-23 exactly; computed so, without a view of the bits as
    # float32 (which torch.func.vmap has no batching rule for in some
    # torch versions)
    floats = (bits >> 9).to(torch.float32) * 2.0 ** -23
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# Giles' single-precision erfinv, the approximation XLA lowers
# ``lax.erf_inv`` to: a degree-8 polynomial in w - 2.5 (w < 5) or in
# sqrt(w) - 3, w = -log1p(-x^2). Up to ~50 ulp off the true erfinv in the
# tails (|erfinv(x)| > 3.5), where ``torch.erfinv`` is within an ulp, so the
# port evaluates the same polynomial to draw XLA's normals.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """fp32 erfinv as XLA computes it (the polynomial above)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_W_LT_5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_W_GE_5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1, x * torch.inf, p * x)


def normal(key, shape):
    """fp32 ``jax.random.normal``: sqrt(2) * erfinv(u), u uniform in
    (nextafter(-1, 0), 1). Uniforms are bit-exact; ``erfinv`` (XLA's
    polynomial) differs from XLA's by an ulp or two, through ``log1p``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32,
                        device=key.device) * erfinv(u)


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
