"""All device kernels launched per train step, memory copies and sets not
counted: K1, K2's ``bwd_kernel`` and ``reduce_kernel``, K3's loss and
terms kernels, and every small launch of the step (the draws' gathers,
the hull gate, Adam per leaf). Nothing to read in a window with no train
steps."""


def read(ctx):
    return ctx["trace"]["n_kernels"] / ctx["steps"] if ctx.get("steps") else None
