"""AdamW with global-norm clipping and a cosine LR schedule.

The reference's (``repro/optim/adamw.py``) on trees of tensors: the
first and second moments are trees shaped like the parameters, in
``state_dtype`` (``"bfloat16"`` halves optimizer memory); every update's
math runs in float32 under ``torch.no_grad()``, and ``update`` returns new
tensors (the parameters and state passed in are left as they were).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import lm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """step -> learning rate (a float32 tensor on the step's device):
    linear warm-up to ``base_lr``, then a cosine down to ``min_frac`` of
    it at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable                 # step -> learning rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" halves m/v memory

    def init(self, params):
        """``{"m", "v"}`` zeros shaped like ``params`` in ``state_dtype``,
        on each parameter's device, and ``"step"`` an int32 0."""
        dt = getattr(torch, self.state_dtype)
        zeros = lambda p: torch.zeros_like(p, dtype=dt)   # placed like p
        dev = next(lm.tree_leaves(params)).device
        return {"m": lm.tree_map(zeros, params),
                "v": lm.tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict, Dict]:
        """Returns (new_params, new_state, metrics ``{"gnorm", "lr"}``).
        Gradients are clipped to a global norm of ``clip_norm``; weight
        decay applies to tensors of two or more dims (not norms, biases);
        the bias corrections ``1 - b ** step`` are float32."""
        step = state["step"] + 1
        g_leaves = list(lm.tree_leaves(grads))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in g_leaves))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** step.to(torch.float32)
        c2 = 1 - b2 ** step.to(torch.float32)
        sdt = getattr(torch, self.state_dtype)
        f32 = torch.float32

        def upd(p, g, m, v):
            g = g.to(f32) * scale
            m32 = b1 * m.to(f32) + (1 - b1) * g
            v32 = b2 * v.to(f32) + (1 - b2) * g * g
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
                delta = delta + self.weight_decay * p.to(f32)
            newp = p.to(f32) - lr * delta
            return newp.to(p.dtype), m32.to(sdt), v32.to(sdt)

        new = [upd(p, g, m, v) for p, g, m, v in zip(
            lm.tree_leaves(params), g_leaves, lm.tree_leaves(state["m"]),
            lm.tree_leaves(state["v"]))]
        tree = lambda i: lm.tree_unflatten(params, (t[i] for t in new))
        return (tree(0), {"m": tree(1), "v": tree(2), "step": step},
                {"gnorm": gnorm, "lr": lr})
