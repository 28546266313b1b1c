"""ce_roofline.train: the frozen bound of the fused cross-entropy kernel at
a training step's shape (every token of the batch against the whole
vocabulary; the head's float32 master as the op's input), times its
launches, over the summed device time of its two kernels (the partial
pass and the combine), in percent."""

from _rooflines import bound_s, ce_bytes, ce_flops, kernel_seconds, share

#: one launch is a partial pass and a combine: the combine is counted in
#: the time, the pass counts the launches
PASS = ("crossentropy_tc_kernel", "crossentropy_kernel")
COMBINE = ("crossentropy_combine",)


def read(ctx):
    c, t = ctx["config"], ctx["traffic"]
    if ctx["kind"] != "train":
        return None
    T, D, V = t["batch"] * t["seq_len"], c["hidden_size"], c["vocab_size"]
    dtype = c["compute_dtype"]
    bound, _ = bound_s(ce_flops(T, D, V), ce_bytes(T, D, V, dtype, c["param_dtype"]), dtype)
    launches, seconds = kernel_seconds(ctx["kernels"], PASS)
    _, combine = kernel_seconds(ctx["kernels"], COMBINE)
    return share(bound, launches, seconds + combine)
