"""The device's idle share: one less the union of its operations'
intervals over the traced window."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr["busy_s"] > 0 else None
