"""The WKV6 backward's share of its roofline: the bound of one call at the
cell's shape (``counts.wkv6_bwd``) times the calls in the traced window,
over the device time of the kernels those calls launch, found by kernel
name (one ``wkv6_du_reduce`` launch a call, after its state and chunk
passes)."""
UNIT = "%"
LAYER = "kernels (kernels/flash_attention, kernels/wkv6)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
CALLS = r"wkv6_du_reduce$"
KERNELS = r"wkv6_(bwd_|du_reduce|state_pass)"


def read(ctx):
    from benchlib import roofline
    return roofline.share(
        ctx.window, CALLS, KERNELS,
        lambda: ctx.counts.wkv6_bwd(*roofline.wkv6_shape(ctx)))
