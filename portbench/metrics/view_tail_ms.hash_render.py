"""A hash-field view's tail: from the end of the view's last
``hash_field_kernel`` on the device to the end of the last device operation
launched inside the program's ``nerfca.eval.view`` span (the last tile's
Beer-Lambert kernel and the outputs' copies), in ms, the median over the
traced views. ``portbench/spans.py`` starts the tail at the last K1, which
such a view does not run; the operations are attributed to a view as there
(the runtime call that launched each began inside the span). Nothing to
read where the program has no such span or kernel."""

import statistics

KERNEL = "hash_field_kernel"


def tails(views: list, device: list, calls: dict) -> list:
    """Per view span with a hash-field kernel, its tail in ms: ``views``,
    ``device`` and ``calls`` as ``spans.profiler_events`` gives them."""
    out = []
    for a, b in sorted(views):
        ops = [op for op in device if a <= calls.get(op[3], -1) <= b]
        ends = [op[1] for op in ops if KERNEL in op[2]]
        if ends:
            out.append((max(op[1] for op in ops) - max(ends)) * 1e-6)
    return out


def read(ctx):
    values = tails(*ctx["view_events"]) if ctx.get("view_events") else []
    return statistics.median(values) if values else None
