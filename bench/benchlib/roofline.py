"""A kernel's share of its roofline from the traced window: the bound of
one call (``counts``) times the calls, over the device time of the
kernels those calls launched."""
from __future__ import annotations

from typing import Callable, Optional

from benchlib import counts


def share(window, calls: str, kernels: str,
          bytes_ops: Callable[[], tuple]) -> Optional[float]:
    """100 x calls x the bound of one call (``bytes_ops()``: its bytes and
    FLOP) / the kernels' seconds; None where the window ran no such call."""
    n = window.kernel_count(calls)
    seconds = window.kernel_seconds(kernels)
    if not n or seconds <= 0:
        return None
    return 100.0 * n * counts.bound_s(*bytes_ops()) / seconds


def attention_shape(ctx) -> tuple:
    """(batch, seq, heads, kv heads, head dim) of the cell's attention."""
    c = ctx.cfg
    return (ctx.traffic["batch"], ctx.traffic["seq"],
            c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"])


def wkv6_shape(ctx) -> tuple:
    """(batch, seq, heads, head size) of the cell's time-mix."""
    c = ctx.cfg
    return (ctx.traffic["batch"], ctx.traffic["seq"],
            c["hidden_size"] // c["head_size"], c["head_size"])
