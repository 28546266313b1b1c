"""mfu.train: model FLOPs of the window's training steps over the window's
seconds, as a percent of the H100's dense bf16 peak (989 TFLOP/s).  A step
counts three forward passes' model FLOPs (the forward, and twice that
backward) on each row, by the model family's ``forward_flops``;
recomputation is not counted."""

from _rooflines import PEAK_FLOPS


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    t = ctx["traffic"]
    flops = 3 * t["batch"] * ctx["family"].forward_flops(ctx["config"], t["seq_len"])
    return 100.0 * flops * ctx["steps"] / ctx["window_s"] / PEAK_FLOPS["bfloat16"]
