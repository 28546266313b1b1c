"""mfu.serve: model FLOPs of the prefills of the requests completed in the
window (each prompt's own tokens, pads not counted, by the model family's
``forward_flops``) over the window's seconds, as a percent of the H100's
dense bf16 peak (989 TFLOP/s)."""

from _rooflines import PEAK_FLOPS


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["prompt_lengths"]:
        return None
    flops = sum(ctx["family"].forward_flops(ctx["config"], n) for n in ctx["prompt_lengths"])
    return 100.0 * flops / ctx["window_s"] / PEAK_FLOPS["bfloat16"]
