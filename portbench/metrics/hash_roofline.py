"""The hash-field kernel's share of its roofline: the least time the card
could take for the traced window's views (:func:`view_bound_s`) over the
device time of ``hash_field_kernel``. Nothing to read where the window runs
no such kernel.

The bound is the largest of three terms a view:

  - the bytes the view has to move to or from HBM (:func:`hbm_bytes`: the
    table read once, the raw densities written, the rays and depths read)
    at 3.35 TB/s;
  - the corner reads (:func:`corner_bytes`: 8 corners a level, 4 B a
    feature, 1 KB a point) at the card's L2 read bandwidth: the 48.8 MB
    table stays in the 50 MB L2 across a view, so the corners come from
    there, not from HBM;
  - the MLP's operations at the f32 peak of the CUDA cores, the arithmetic
    the kernel uses (no tensor cores).

On the H100 the MLP's term is the largest (0.95 ms a 40000 x 192 view,
against 0.90 for the corner reads and 0.02 for the HBM bytes). The corner
term counts each read's 8 bytes once, as though every read of a warp hit
L2 and none were served from L1; a kernel that serves a large share of its
reads from L1 (neighbouring samples share cells at the coarse levels) could
take less time than it, but not less than the MLP's term.

The count functions read the sizes from the configuration: the encoding's
``hash_*`` keys and NAF's MLP (``static_num_layers`` linear layers of
``static_hidden_dim``, the encoding concatenated before each of
``static_skips``, one output)."""

from portbench.counting import PEAK_BYTES
from portbench.reference.hash_render import table_entries
from portbench.tracing import kernel_seconds

PEAK_F32_FMA = 66.9e12  # H100 SXM at 700 W: f32 on the CUDA cores, 2 operations a FMA
# H100 80GB HBM3 at 700 W: the most that L2-only (.cg) streaming reads of a
# buffer resident in L2 reached (8775 GB/s, a 32 MB buffer; 6.5-8.8 TB/s over
# 8-40 MB buffers and three launch shapes, where a 4 GB buffer read 3.16 TB/s
# from HBM), scripts/l2_read_bandwidth.py
PEAK_L2_BYTES = 8.78e12


def encoded(cfg: dict) -> int:
    return cfg["hash_levels"] * cfg["hash_features_per_level"]


def mlp_macs(cfg: dict) -> int:
    """Multiply-adds of the MLP a point."""
    width, enc, n = cfg["static_hidden_dim"], encoded(cfg), cfg["static_num_layers"]
    macs = 0
    for i in range(n):
        fan_in = enc if i == 0 else width + (enc if i in cfg["static_skips"] else 0)
        macs += fan_in * (1 if i == n - 1 else width)
    return macs


def mlp_flops(cfg: dict, points: int) -> float:
    return 2.0 * mlp_macs(cfg) * points


def corner_bytes(cfg: dict, points: int) -> float:
    """Bytes of the corners' features a view reads: 8 corners a level."""
    return points * 8 * encoded(cfg) * 4.0


def hbm_bytes(cfg: dict, rays: int, samples: int) -> float:
    """Bytes a view moves to or from HBM at the least: the table read once,
    the raw density written (4 B a point), the rays (24 B each) and the
    shared depths read."""
    table = table_entries(cfg) * cfg["hash_features_per_level"] * 4.0
    return table + 4.0 * rays * samples + 24.0 * rays + 4.0 * samples


def view_bound_s(cfg: dict, rays: int, samples: int) -> float:
    points = rays * samples
    return max(hbm_bytes(cfg, rays, samples) / PEAK_BYTES,
               corner_bytes(cfg, points) / PEAK_L2_BYTES,
               mlp_flops(cfg, points) / PEAK_F32_FMA)


def read(ctx):
    t = kernel_seconds(ctx["trace"], "hash_field_kernel")
    return 100.0 * ctx["hash_bound_s"] / t if t > 0 and "hash_bound_s" in ctx else None
