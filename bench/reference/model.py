"""The plain reference of the benchmark's training step, written from the
layer equations of the two architectures the cells run: a dense
decoder with GQA attention and RoPE (StarCoder2) and RWKV-6's time-mix
with data-dependent decay. Plain PyTorch in float32, TF32 off, no
kernels, cache or batching tricks; it imports nothing of the program.

Weights are stored as the configuration states (``torch_dtype`` for
every matrix, float32 for norms, biases and per-channel vectors) and
widened to float32 where they are used, so the parameters' change after
a few steps is rounded to the stored dtype, as a run of the
configuration rounds it.

``Reference.step`` follows one step of the delayed-gradient learner
(paper Sec. 4.1, K = 1): the a2c loss of the batch at ``prev`` (the
one-update-old parameters), its gradient, and Adam's update applied to
``params``. To fit beside nothing but its own state it runs layer by
layer: a no-grad forward that keeps each layer's input, the loss head by
sequence chunks, then each layer again with autograd, last first, whose
weights are updated as soon as their gradient is known.

``Precision`` says how the products are computed: ``fp32`` is the
reference; ``fp8`` rounds every operand of a product (weights and
activations on the way in, gradients on the way back) to float8 e4m3
with a per-tensor scale: the control, one precision step below the
configuration's bfloat16; ``bf16`` rounds them to bfloat16, the
configuration's own precision, a witness of what rounding alone does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

# one Adam and one a2c loss, the cells' (the port's launcher defaults)
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
A2C = dict(value_coef=0.5, entropy_coef=0.01)
# tokens a loss-head chunk holds: its (tokens, vocab) fp32 logits and
# their log-softmax live only while the chunk runs
HEAD_TOKENS = 2048
# attention queries a block holds against all the keys before them
QUERY_BLOCK = 512
# WKV: the chunk of the intra-chunk (exact, log-space) form, and the heads
# computed together under one checkpoint
WKV_CHUNK = 32
WKV_HEADS = 8
# the leaves the loss head reads after the last layer
HEAD_LEAVES = ("lm_head", "value_head", "final_norm.scale", "final_norm.bias")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


# ------------------------------------------------------------ precision
def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest finite value, 448), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Rounds the value to fp8 on the way in and its gradient on the way
    back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class _Bf16(torch.autograd.Function):
    """Rounds the value to bfloat16 on the way in and its gradient on the
    way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


class Precision:
    """``q`` is applied to every operand of a product: the identity in
    float32, the fp8 rounding (values and gradients) in ``fp8``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x):
        if self.name == "fp32":
            return x
        return (_Bf16 if self.name == "bf16" else _Fp8).apply(x)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self.q(x) for x in xs))


# ------------------------------------------------------------ parameters
def param_specs(cfg: dict) -> List[Tuple[str, tuple, torch.dtype, tuple]]:
    """(name, shape, stored dtype, init) of every parameter, init being
    ("normal", std) or ("const", value). The names and layouts are the
    ones the program's flat parameter dict uses; the scales are N(0, 1/fan
    in) for matrices, 1 for norm scales, 0 for biases and the value head."""
    dt = _DTYPES[cfg["torch_dtype"]]
    f32 = torch.float32
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    ff = cfg["intermediate_size"]
    arch = cfg["architecture"]
    layernorm = arch == "starcoder2"

    def norm(prefix):
        out = [(f"{prefix}.scale", (d,), f32, ("const", 1.0))]
        if layernorm:
            out.append((f"{prefix}.bias", (d,), f32, ("const", 0.0)))
        return out

    specs = [("embed", (V, d), dt, ("normal", d ** -0.5)),
             ("lm_head", (d, V), dt, ("normal", d ** -0.5)),
             ("value_head", (d, 1), f32, ("const", 0.0))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        specs += norm(f"{p}.norm1")
        if arch == "starcoder2":
            H, KV, dh = (cfg["num_attention_heads"],
                         cfg["num_key_value_heads"], cfg["head_dim"])
            fan_d = ("normal", d ** -0.5)
            specs += [(f"{p}.mixer.wq", (d, H, dh), dt, fan_d),
                      (f"{p}.mixer.wk", (d, KV, dh), dt, fan_d),
                      (f"{p}.mixer.wv", (d, KV, dh), dt, fan_d),
                      (f"{p}.mixer.wo", (H, dh, d), dt,
                       ("normal", (H * dh) ** -0.5))]
        elif arch == "rwkv6":
            N = cfg["head_size"]
            H, R = d // N, cfg["decay_lora_rank"]
            specs.append((f"{p}.mixer.mu", (5, d), f32, ("const", 0.5)))
            specs += [(f"{p}.mixer.w_{n}", (d, d), dt, ("normal", d ** -0.5))
                      for n in "rkvgo"]
            specs += [(f"{p}.mixer.w0", (d,), f32, ("const", -6.0)),
                      (f"{p}.mixer.w_lora_a", (d, R), f32,
                       ("normal", d ** -0.5)),
                      (f"{p}.mixer.w_lora_b", (R, d), f32,
                       ("normal", R ** -0.5)),
                      (f"{p}.mixer.u", (H, N), f32, ("normal", 0.1)),
                      (f"{p}.mixer.ln_scale", (H, N), f32, ("const", 1.0))]
        else:
            raise ValueError(f"unknown architecture {arch!r}")
        specs += norm(f"{p}.norm2")
        specs += [(f"{p}.ffn.w_in", (d, ff), dt, ("normal", d ** -0.5)),
                  (f"{p}.ffn.w_out", (ff, d), dt, ("normal", ff ** -0.5))]
    specs += norm("final_norm")
    return specs


# ------------------------------------------------------------ the layers
def _norm(x, w: dict, prefix: str, eps: float):
    """LayerNorm (with a bias) or RMSNorm (without), population variance."""
    scale = w[f"{prefix}.scale"]
    if f"{prefix}.bias" in w:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale + w[f"{prefix}.bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """Half-split rotary embedding at positions 0..S-1. x: (B, S, H, Dh)."""
    S, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, w: dict, cfg: dict, prec: Precision):
    """Causal GQA self-attention with RoPE, softmax(q k^T / sqrt(Dh)) v,
    query block by query block against the keys up to the block's end."""
    B, S, d = h.shape
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    R = H // KV
    q = prec.mm(h, w["mixer.wq"].reshape(d, H * dh)).view(B, S, H, dh)
    k = prec.mm(h, w["mixer.wk"].reshape(d, KV * dh)).view(B, S, KV, dh)
    v = prec.mm(h, w["mixer.wv"].reshape(d, KV * dh)).view(B, S, KV, dh)
    q = _rope(q, cfg["rope_theta"]).view(B, S, KV, R, dh)
    k = _rope(k, cfg["rope_theta"])
    outs = []
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        s = prec.einsum("bqgrd,bkgd->bgrqk", q[:, q0:q1], k[:, :q1]) \
            * dh ** -0.5
        qpos = torch.arange(q0, q1, device=h.device)[:, None]
        kpos = torch.arange(q1, device=h.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(prec.einsum("bgrqk,bkgd->bqgrd", p, v[:, :q1]))
    o = torch.cat(outs, dim=1).reshape(B, S, H * dh)
    return prec.mm(o, w["mixer.wo"].reshape(H * dh, d))


def wkv6(r, k, v, logw, u, chunk: int = WKV_CHUNK):
    """The WKV6 recurrence from a zero state, per head (dim N):

        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

    r, k, v, logw = log w: (B, T, H, N); u: (H, N). In chunks: inside a
    chunk every decay product is exp of a sum of log w over the steps
    between, never a quotient (w may be near 0); across chunks the state
    is carried step by step."""
    B, T, H, N = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    n = (T + pad) // chunk

    def split(t):            # (B, H, n, L, N)
        return t.reshape(B, n, chunk, H, N).permute(0, 3, 1, 2, 4)

    r, k, v, lw = map(split, (r, k, v, logw))
    A = lw.cumsum(3)         # sum of log w over the chunk's steps <= t
    Ax = A - lw              # ... < t
    idx = torch.arange(chunk, device=r.device)
    lower = (idx[:, None] > idx[None, :])[..., None]      # (t, s, 1)
    # decay from step s to step t - 1 inside the chunk, s < t
    dec = torch.where(lower, Ax[..., :, None, :] - A[..., None, :, :],
                      float("-inf")).exp()
    att = torch.einsum("bhntc,bhnsc,bhntsc->bhnts", r, k, dec)
    bonus = (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True)
    o = att @ v + bonus * v
    # each chunk's state contribution and total decay
    kv = (k * torch.exp(A[..., -1:, :] - A)).transpose(-1, -2) @ v
    total = torch.exp(A[..., -1, :])[..., None]            # (B, H, n, N, 1)
    S = r.new_zeros(B, H, N, N)
    states = []
    for c in range(n):
        states.append(S)
        S = total[:, :, c] * S + kv[:, :, c]
    o = o + (r * torch.exp(Ax)) @ torch.stack(states, dim=2)
    return o.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, N)[:, :T]


def _wkv6_by_heads(r, k, v, logw, u):
    """``wkv6`` over groups of heads, each under a checkpoint: its
    (L, L, N) decay tensors live one group at a time."""
    outs = []
    for h0 in range(0, r.shape[2], WKV_HEADS):
        sl = slice(h0, h0 + WKV_HEADS)
        args = (r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl],
                u[sl])
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                wkv6, *args, use_reentrant=False))
        else:
            outs.append(wkv6(*args))
    return torch.cat(outs, dim=2)


def _time_mix(h, w: dict, cfg: dict, prec: Precision):
    """RWKV-6 time-mix: a static token-shift lerp of five streams, r, k,
    v, the SiLU gate g, the data-dependent decay w = exp(-exp(w0 +
    tanh(x_w A) B)), the WKV recurrence, a per-head RMS norm, the gate and
    the output projection."""
    B, S, D = h.shape
    N = cfg["head_size"]
    H = D // N
    shifted = F.pad(h, (0, 0, 1, 0))[:, :-1]
    mu = w["mixer.mu"]
    xr, xk, xv, xw, xg = (h + mu[i] * (shifted - h) for i in range(5))
    r = prec.q(prec.mm(xr, w["mixer.w_r"]).view(B, S, H, N))
    k = prec.q(prec.mm(xk, w["mixer.w_k"]).view(B, S, H, N))
    v = prec.q(prec.mm(xv, w["mixer.w_v"]).view(B, S, H, N))
    g = F.silu(prec.mm(xg, w["mixer.w_g"]))
    # the decay's low-rank path is float32 in the configuration
    dec = w["mixer.w0"] + torch.tanh(xw @ w["mixer.w_lora_a"]) \
        @ w["mixer.w_lora_b"]
    logw = -torch.exp(dec).view(B, S, H, N)
    o = _wkv6_by_heads(r, k, v, logw, w["mixer.u"])
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True)
                        + cfg["head_norm_epsilon"]) * w["mixer.ln_scale"]
    return prec.mm(o.reshape(B, S, D) * g, w["mixer.w_o"])


def layer(x, w: dict, cfg: dict, prec: Precision):
    """One pre-norm residual layer: mixer, then the GeLU (tanh) FFN."""
    eps = cfg["norm_epsilon"]
    h = _norm(x, w, "norm1", eps)
    if cfg["architecture"] == "starcoder2":
        x = x + _attention(h, w, cfg, prec)
    else:
        x = x + _time_mix(h, w, cfg, prec)
    h = _norm(x, w, "norm2", eps)
    ff = F.gelu(prec.mm(h, w["ffn.w_in"]), approximate="tanh")
    return x + prec.mm(ff, w["ffn.w_out"])


def _head_sums(x, w: dict, cfg: dict, prec: Precision, batch: dict):
    """(pg, value, entropy) sums of a chunk of final hidden states: the
    final norm, fp32 logits and values, the a2c terms under the mask."""
    hf = _norm(x, w, "final_norm", cfg["norm_epsilon"])
    logits = prec.mm(hf, w["lm_head"])
    values = (hf @ w["value_head"])[..., 0]
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, batch["actions"].long()[..., None])[..., 0]
    ent = -(torch.exp(logp) * logp).sum(-1)
    m = batch["loss_mask"]
    pg = -(lp * batch["advantages"] * m).sum()
    vl = (torch.square(values - batch["returns"]) * m).sum()
    return pg, vl, (ent * m).sum()


# ------------------------------------------------------------ training
class Reference:
    """The learner's state (params, prev, Adam's m and v) and its step.
    ``theta0``: {name: tensor in its stored dtype}; it becomes
    ``params``, and a copy ``prev``."""

    def __init__(self, cfg: dict, theta0: Dict[str, torch.Tensor],
                 lr: float, precision: str = "fp32"):
        self.cfg = cfg
        self.prec = Precision(precision)
        self.lr = lr
        self.params = dict(theta0)
        self.prev = {n: t.clone() for n, t in theta0.items()}
        self.m = {n: torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for n, t in theta0.items()}
        self.v = {n: torch.zeros_like(m) for n, m in self.m.items()}
        self.t = 0
        self.n_layers = cfg["num_hidden_layers"]

    def _weights(self, prefix: str, grad: bool) -> dict:
        """The float32 copies of layer ``prefix``'s leaves of ``prev``,
        named without the prefix; leaves of autograd when ``grad``."""
        return {n[len(prefix):]: t.float().requires_grad_(grad)
                for n, t in self.prev.items() if n.startswith(prefix)}

    def _adam(self, name: str, g: torch.Tensor) -> None:
        """Adam on ``params[name]`` with the gradient taken at ``prev``;
        the old params become the new prev."""
        b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
        m, v = self.m[name], self.v[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        u = -self.lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p = self.params[name]
        self.prev[name] = p
        self.params[name] = (p.float() + u).to(p.dtype)

    def step(self, batch: dict,
             on_grad: Optional[Callable[[str, torch.Tensor], None]] = None
             ) -> Dict[str, float]:
        """One delayed-gradient step on ``batch`` ((B, S) tensors: tokens,
        actions, advantages, returns, loss_mask); returns the a2c loss at
        ``prev`` and its terms (``loss``, ``pg``, ``value``, ``entropy``).
        ``on_grad(name, g)`` sees each leaf's float32 gradient before Adam
        takes it."""
        cfg, prec = self.cfg, self.prec
        self.t += 1
        tokens = batch["tokens"].long()
        B, S = tokens.shape
        d = cfg["hidden_size"]
        # forward without autograd, keeping each layer's input
        with torch.no_grad():
            x = self.prev["embed"][tokens].float() * math.sqrt(d)
            inputs = [x]
            for i in range(self.n_layers):
                x = layer(x, self._weights(f"layers.{i}.", False), cfg, prec)
                inputs.append(x)
        # the loss head, chunk by chunk of sequence positions
        cnt = max(float(batch["loss_mask"].sum()), 1.0)
        head = {n: self.prev[n].float().requires_grad_(True)
                for n in HEAD_LEAVES if n in self.prev}
        xL = inputs.pop().requires_grad_(True)
        sums = [0.0, 0.0, 0.0]
        c = max(1, HEAD_TOKENS // B)
        for s0 in range(0, S, c):
            sl = slice(s0, s0 + c)
            part = {k: t[:, sl] for k, t in batch.items()}
            pg, vl, ent = _head_sums(xL[:, sl], head, cfg, prec, part)
            loss = (pg + A2C["value_coef"] * vl
                    - A2C["entropy_coef"] * ent) / cnt
            loss.backward()
            for i, t in enumerate((pg, vl, ent)):
                sums[i] += float(t.detach())
        pg, vl, ent = (x / cnt for x in sums)
        total = pg + A2C["value_coef"] * vl - A2C["entropy_coef"] * ent
        dx = xL.grad
        del xL
        for n, t in head.items():
            self._update(n, t.grad, on_grad)
        del head
        # each layer again with autograd, last first
        for i in reversed(range(self.n_layers)):
            xin = inputs.pop().requires_grad_(True)
            w = self._weights(f"layers.{i}.", True)
            layer(xin, w, cfg, prec).backward(dx)
            dx = xin.grad
            del xin
            for n, t in w.items():
                self._update(f"layers.{i}.{n}", t.grad, on_grad)
            del w
        # the embedding: each token's rows summed into its row
        g = torch.zeros(self.prev["embed"].shape, dtype=torch.float32,
                        device=dx.device)
        g.index_add_(0, tokens.reshape(-1),
                     dx.reshape(-1, d) * math.sqrt(d))
        self._update("embed", g, on_grad)
        return {"loss": total, "pg": pg, "value": vl, "entropy": ent}

    def _update(self, name, g, on_grad) -> None:
        if on_grad is not None:
            on_grad(name, g)
        self._adam(name, g)
