"""The window's share of the card's dense bf16 peak: the model FLOPs of
a step (``counts.step_model_flops``) times the traced window's steps,
over the window's length times the peak. It bounds every kernel's gain:
a kernel taken off the path leaves its own roofline silent, not this."""
UNIT = "%"
LAYER = "learner step (core/learner.py, core/delayed_grad.py)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    w = ctx.window
    flops = ctx.counts.step_model_flops(ctx.cfg, ctx.traffic["batch"],
                                        ctx.traffic["seq"])
    return 100.0 * flops * w.steps / (w.window_s * ctx.counts.PEAK_BF16_FLOPS)
