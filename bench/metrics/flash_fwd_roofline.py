"""The flash attention forward's share of its roofline: the bound of one
call at the cell's shape (``counts.flash_fwd``) times the calls in the
traced window, over the device time of the kernels those calls launch,
found by kernel name (one ``flash_fwd_*`` launch a call)."""
UNIT = "%"
LAYER = "kernels (kernels/flash_attention, kernels/wkv6)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
CALLS = r"flash_fwd_(bf16|f32)$"
KERNELS = r"flash_fwd_"


def read(ctx):
    from benchlib import roofline
    return roofline.share(
        ctx.window, CALLS, KERNELS,
        lambda: ctx.counts.flash_fwd(*roofline.attention_shape(ctx)))
