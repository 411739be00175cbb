"""The flash attention backward's share of its roofline: the bound of one
call at the cell's shape (``counts.flash_bwd``) times the calls in the
traced window, over the device time of the kernels those calls launch,
found by kernel name (one ``flash_bwd_bf16`` (or ``flash_bwd_dkdv_f32``)
launch a call, beside its rows and dQ passes)."""
UNIT = "%"
LAYER = "kernels (kernels/flash_attention, kernels/wkv6)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
CALLS = r"flash_bwd_(bf16|dkdv_f32)$"
KERNELS = r"flash_bwd_"


def read(ctx):
    from benchlib import roofline
    return roofline.share(
        ctx.window, CALLS, KERNELS,
        lambda: ctx.counts.flash_bwd(*roofline.attention_shape(ctx)))
