"""A view's lead-in: from the start of the program's ``nerfca.eval.view``
span to the start of the view's first K1 on the device, in ms, the median
over the traced views (``portbench/spans.py``). The previous view's pixels
are on the host by then, so the device waits all of it. Nothing to read
where the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.median(ctx, "lead_ms")
