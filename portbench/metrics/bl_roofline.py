"""The static method's Beer-Lambert kernel's share of its roofline: the
least time the card could take to move the bytes its work needs over the
traced window's views (:func:`view_bytes`, at 3.35 TB/s: it does a few
operations a byte) over the device time of ``static_composite_kernel``.
Nothing to read where the window runs no such kernel."""

from portbench.counting import PEAK_BYTES
from portbench.tracing import kernel_seconds


def view_bytes(rays: int, samples: int) -> float:
    """Bytes of one view's render over the shared ``[S]`` depths, each
    read or written once: the raw density read and the sigma written, 4 B
    each a sample; the pixel written, 4 B a ray; the depths read and the
    dists written, 4 B each a sample of the shared grid."""
    return 8.0 * rays * samples + 4.0 * rays + 8.0 * samples


def read(ctx):
    t = kernel_seconds(ctx["trace"], "static_composite_kernel")
    if t <= 0 or "rays" not in ctx:
        return None
    return 100.0 * ctx["views"] * view_bytes(ctx["rays"], ctx["samples"]) / PEAK_BYTES / t
