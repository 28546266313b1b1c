"""decode_ms.serve: the median time of the window's decode steps, in
milliseconds: the harness's CUDA events recorded around each call of the
``Engine`` into its decode step (no synchronize added), read after the
window."""

import statistics


def read(ctx):
    steps = ctx["spans"].get("decode", [])
    if ctx["kind"] != "serve" or not steps:
        return None
    return 1e3 * statistics.median(steps)
