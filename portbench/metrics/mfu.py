"""The whole step's or view's share of the card's peak: the operations of
the traced window's work (a train step: three forward passes, forward and
backward with the recompute not counted; a view: every field's forward
over its points) over the window, against the peak of the configuration's
compute precision."""


def read(ctx):
    return 100.0 * ctx["flops"] / ctx["trace"]["window_s"] / ctx["peak_flops"]
