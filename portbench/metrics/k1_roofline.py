"""K1's share of its roofline: the least time the card could take for
every field's forward over the traced window's steps or views
(``counting.k1_bound_s``) over the device time of ``fwd_kernel`` (K1
alone, inside K3, or the one-field K1)."""

from portbench.tracing import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx["trace"], "fwd_kernel")
    return 100.0 * ctx["k1_bound_s"] / t if t > 0 else None
