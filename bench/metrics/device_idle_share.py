"""The share of the traced window in which no operation ran on the card:
100 less the union of its device operations' intervals (kernels,
copies, fills) over the window."""
UNIT = "%"
LAYER = "device (H100)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    w = ctx.window
    return 100.0 * (1.0 - w.busy_s / w.window_s)
