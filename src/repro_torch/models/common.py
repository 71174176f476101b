"""Shared model building blocks: a seeded initializer, norms, rotary
embeddings and numeric helpers, as plain functions on tensors.

Parameters are nested dicts of tensors with the reference's leaf names
and layouts (``repro.models``), so a reference tree carries over leaf for
leaf (``models.convert``).  Every leaf is drawn with its *logical axes*
(one name or None per dim, the reference's), which the init functions
pass to :class:`Init`; ``record_axes`` collects them, and
``lm.param_axes`` builds the axes tree beside a parameter tree, for the
sharding rules (``repro_torch.parallel``).
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

# While ``record_axes`` is active: id(leaf) -> (leaf, logical axes) of
# every leaf an Init draws (the leaf is held so its id stays unique).
_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_axes", default=None)


@contextlib.contextmanager
def record_axes():
    """Collect the logical axes of every leaf drawn inside the block:
    yields the dict ``id(leaf) -> (leaf, axes)``."""
    rec: dict = {}
    tok = _AXES.set(rec)
    try:
        yield rec
    finally:
        _AXES.reset(tok)


def _leaf(t: torch.Tensor, axes) -> torch.Tensor:
    axes = tuple(axes)
    if len(axes) != t.dim():
        raise ValueError(f"logical axes {axes} for a {t.dim()}-dim leaf")
    rec = _AXES.get()
    if rec is not None:
        rec[id(t)] = (t, axes)
    return t


def device_or_card(device) -> torch.device:
    """``device``, or the current CUDA card when it is None: an entry point
    runs on the card unless the caller names another device, and raises
    when there is no card rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device=None means the CUDA card, and none "
                               "was found; pass device='cpu' to run on the "
                               "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Init:
    """Seeded initializer: one ``torch.Generator`` on the target device
    draws every leaf in order, directly in ``dtype`` (a 20B-parameter model
    is never materialised in fp32).  ``device=None`` is the card; on the
    ``meta`` device the leaves carry shapes only."""

    def __init__(self, seed: int, dtype=torch.float32, device=None):
        self.dtype = dtype
        self.device = device_or_card(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, shape, axes, scale=0.02):
        v = torch.randn(tuple(shape), generator=self.gen, dtype=self.dtype,
                        device=self.device)
        return _leaf(v.mul_(scale), axes)

    def zeros(self, shape, axes):
        return _leaf(torch.zeros(tuple(shape), dtype=self.dtype,
                                 device=self.device), axes)

    def ones(self, shape, axes):
        return _leaf(torch.ones(tuple(shape), dtype=self.dtype,
                                device=self.device), axes)

    def const(self, value, axes):
        """A leaf holding ``value`` (host numbers, rounded to ``dtype``)."""
        return _leaf(torch.as_tensor(np.asarray(value), dtype=self.dtype).to(
            self.device), axes)


class StackedInit(Init):
    """Init that prepends a ``(layers,)`` dim to every leaf it draws (and
    the logical axis ``"layers"`` to its axes)."""

    def __init__(self, parent: Init, n: int):
        self.dtype, self.device, self.gen = (parent.dtype, parent.device,
                                             parent.gen)
        self.n = n

    def normal(self, shape, axes, scale=0.02):
        return super().normal((self.n,) + tuple(shape),
                              ("layers",) + tuple(axes), scale)

    def zeros(self, shape, axes):
        return super().zeros((self.n,) + tuple(shape),
                             ("layers",) + tuple(axes))

    def ones(self, shape, axes):
        return super().ones((self.n,) + tuple(shape),
                            ("layers",) + tuple(axes))

    def const(self, value, axes):
        # One copy per layer, each its own storage (not an expanded view).
        v = torch.as_tensor(np.asarray(value), dtype=self.dtype).to(
            self.device)
        return _leaf(v.expand((self.n,) + tuple(v.shape)).clone(),
                     ("layers",) + tuple(axes))


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(x.dtype)


def layer_norm(x, weight, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def apply_norm(x, p, kind: str, eps: float):
    if kind == "layer":
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def init_norm(init: Init, d: int, kind: str):
    if kind == "layer":
        return {"w": init.ones((d,), (None,)),
                "b": init.zeros((d,), (None,))}
    return {"w": init.zeros((d,), (None,))}  # rms stored as (1 + w)


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial fraction supported)
# ---------------------------------------------------------------------------

def rope_frequencies(hd: int, frac: float, theta: float, device=None):
    """Inverse frequencies for the rotated sub-dimension (rot_dim//2,)."""
    rot = int(hd * frac) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.tensor(inv, dtype=torch.float32, device=device), rot


def apply_rope(x, positions, frac=1.0, theta=10000.0):
    """x: (..., S, n_heads, hd); positions: broadcastable to (..., S).

    Half-split rotation (not interleaved) of the leading ``rot`` dims."""
    hd = x.shape[-1]
    inv, rot = rope_frequencies(hd, frac, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), xp], dim=-1)


def yarn_frequencies(dim: int, theta: float, yarn) -> np.ndarray:
    """YaRN's inverse frequencies (dim // 2,) in float64, as DeepSeek-V3's
    ``precompute_freqs_cis``: pair i keeps theta ** (-2 i / dim) below the
    correction range (fast rotations, ``beta_fast`` turns or more over the
    original context), takes it over ``factor`` above it (``beta_slow``
    turns or fewer), and blends the two linearly in between."""
    inv = theta ** (-np.arange(0, dim, 2, dtype=np.float64) / dim)

    def corr(turns):
        return dim * np.log(yarn.original_max_pos / (turns * 2 * np.pi)) \
            / (2 * np.log(theta))

    low = max(int(np.floor(corr(yarn.beta_fast))), 0)
    high = min(int(np.ceil(corr(yarn.beta_slow))), dim - 1)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / ((high - low) or 0.001), 0.0, 1.0)
    return inv / yarn.factor * ramp + inv * (1.0 - ramp)


def yarn_mscale(yarn) -> float:
    """The factor YaRN puts on the softmax scale: mscale squared,
    ``0.1 * mscale_all_dim * ln(factor) + 1`` (DeepSeek-V3's MLA)."""
    if yarn.factor <= 1:
        return 1.0
    m = 0.1 * yarn.mscale_all_dim * float(np.log(yarn.factor)) + 1.0
    return m * m


def rotate(x, positions, inv):
    """``apply_rope``'s half-split rotation of all of ``x``'s last dim by
    given inverse frequencies ``inv`` (hd // 2,) float32."""
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x2 * cos + x1 * sin).to(x.dtype)], dim=-1)


def einsum(eq: str, x, w, x_axes, w_axes):
    """``torch.einsum(eq, x, w)``; on DTensors under installed sharding
    rules a ``parallel.context.sharded_einsum``, each operand placed by
    its logical axes (DTensor's own choice for a matmul may replicate the
    computation over an axis the weight is sharded on)."""
    from repro_torch.parallel import context
    from torch.distributed.tensor import DTensor

    if context.current_rules() is None or not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    return context.sharded_einsum(eq, x, w, x_axes, w_axes)


def silu(x):
    return x * torch.sigmoid(x)


def cdtype(cfg) -> torch.dtype:
    return cfg.compute_dtype
