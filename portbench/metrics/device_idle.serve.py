"""device_idle.serve: the share of the traced window of a serving cell in
which no operation ran on the device, in percent."""


def read(ctx):
    if ctx["kind"] != "serve" or ctx.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
