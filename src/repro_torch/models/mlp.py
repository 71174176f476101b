"""Dense feed-forward blocks (SwiGLU) used by every architecture."""
from __future__ import annotations

from repro_torch.models import common as cm
from repro_torch.parallel import context


def init_mlp(init: cm.Init, d: int, d_ff: int):
    return {
        "wg": init.normal((d, d_ff), ("embed", "d_ff")),
        "wu": init.normal((d, d_ff), ("embed", "d_ff")),
        "wd": init.normal((d_ff, d), ("d_ff", "embed")),
    }


def mlp_block(p, x):
    """SwiGLU; sharded, the hidden dim over the ``d_ff`` axis and the
    output summed over it, in ``x``'s dtype, onto ``x``'s placement."""
    xa, ha = ("batch", "seq", None), ("batch", "seq", "d_ff")
    g = cm.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype), xa, (None, "d_ff"))
    u = cm.einsum("bsd,df->bsf", x, p["wu"].to(x.dtype), xa, (None, "d_ff"))
    h = cm.silu(g) * u
    y = cm.einsum("bsf,fd->bsd", h, p["wd"].to(x.dtype), ha, ("d_ff", None))
    return context.constrain(y, xa)
