"""Kernels launched by one training step: the traced window's kernel
events over its steps. Every step of the window must launch as many, or
the reading is not measured (the profiler lost events, or the step's
work changed)."""
UNIT = "launches"
LAYER = ("model step dispatch (models/backbone.py, models/layers.py, "
         "optim/optimizers.py)")
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(ctx):
    per_step = ctx.window.launches_by_step()
    if not per_step or len(set(per_step)) != 1:
        return None
    return float(per_step[0])
