"""The whole-model clip a push: the mean of the system's fenced
``push.clip`` spans (``plan_sq_norms``, ``sqrt_f32``, ``clip_scales``) per
push of the window, in ms."""
from bench.metrics_stages import stage_ms_per_push


def read(ctx):
    return stage_ms_per_push(ctx, "push.clip")
