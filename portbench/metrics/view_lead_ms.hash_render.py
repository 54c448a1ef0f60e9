"""A hash-field view's lead-in: from the start of the program's
``nerfca.eval.view`` span to the start of the view's first
``hash_field_kernel`` on the device, in ms, the median over the traced
views. ``portbench/spans.py`` ends the lead at the first K1, which such a
view does not run; the operations are attributed to a view as there (the
runtime call that launched each began inside the span). Nothing to read
where the program has no such span or kernel."""

import statistics

KERNEL = "hash_field_kernel"


def leads(views: list, device: list, calls: dict) -> list:
    """Per view span with a hash-field kernel, its lead in ms: ``views``,
    ``device`` and ``calls`` as ``spans.profiler_events`` gives them."""
    out = []
    for a, b in sorted(views):
        starts = [op[0] for op in device if KERNEL in op[2] and a <= calls.get(op[3], -1) <= b]
        if starts:
            out.append((min(starts) - a) * 1e-6)
    return out


def read(ctx):
    values = leads(*ctx["view_events"]) if ctx.get("view_events") else []
    return statistics.median(values) if values else None
