"""K2's share of its roofline: the least time the card could take for
K2's work over the traced window's steps (three forwards' operations of
every field, ``counting.k2_bound_s``) over the device time of
``bwd_kernel`` and its ``reduce_kernel``. Nothing to read where the
window runs no K2 (a render)."""

from portbench.tracing import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx["trace"], "bwd_kernel", "reduce_kernel")
    return 100.0 * ctx["k2_bound_s"] / t if t > 0 and "k2_bound_s" in ctx else None
