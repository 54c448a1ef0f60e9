"""A view's tail: from the end of its last K1 to the end of the last
device operation launched inside the program's ``nerfca.eval.view`` span
(the tiles' joins and the three Beer-Lambert renders, with the gaps
between them), in ms, the median over the traced views
(``portbench/spans.py``). Nothing to read where the program has no such
span."""

from portbench import spans


def read(ctx):
    return spans.median(ctx, "tail_ms")
