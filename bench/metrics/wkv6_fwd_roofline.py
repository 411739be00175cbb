"""The WKV6 forward's share of its roofline: the bound of one call at the
cell's shape (``counts.wkv6_fwd``) times the calls in the traced window,
over the device time of the kernels those calls launch, found by kernel
name (one ``wkv6_chunked`` (or recurrent ``wkv6_kernel``) launch a
call)."""
UNIT = "%"
LAYER = "kernels (kernels/flash_attention, kernels/wkv6)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
CALLS = r"wkv6_(chunked|kernel)$"
KERNELS = r"wkv6_(chunked|kernel)$"


def read(ctx):
    from benchlib import roofline
    return roofline.share(
        ctx.window, CALLS, KERNELS,
        lambda: ctx.counts.wkv6_fwd(*roofline.wkv6_shape(ctx)))
