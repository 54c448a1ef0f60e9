"""The device kernels launched inside the program's ``nerfca.eval.view``
span, K1 included, memory copies and sets not counted, the median over the
traced views (``portbench/spans.py``). Nothing to read where the program
has no such span."""

from portbench import spans


def read(ctx):
    return spans.median(ctx, "launches")
