"""Dense feed-forward blocks (SwiGLU) used by every architecture."""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def init_mlp(init: cm.Init, d: int, d_ff: int):
    return {
        "wg": init.normal((d, d_ff)),
        "wu": init.normal((d, d_ff)),
        "wd": init.normal((d_ff, d)),
    }


def mlp_block(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["wu"].to(x.dtype))
    h = cm.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["wd"].to(x.dtype))
