"""The MLA decode kernel against its plain version on the card.

``case`` draws one core's inputs on a device from a seed: queries, a
latent cache of ``t`` positions (optionally as strided views of one
buffer, or in another type than the queries) and the rows' positions.
``compare`` runs ``ops.attend`` and the plain core
(``models.attention.mla_attend``) on them and returns both errors against
a float64 evaluation of the same rounded operands; ``time_core`` times
both.  ``chat_positions`` draws rows' depths as the chat mix leaves them
(prompts log-uniform 128-2,048, answers uniform 64-512, a row anywhere in
its answer), and ``boundary_positions`` the depths around each split's
edges.

Used by ``chip_smoke.py``, ``tools/mla_decode_times.py`` and
``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.mla_decode import ops
from repro_torch.models import attention

# The chat mix's lengths (cabench/traffic/chat-256.json).
PROMPTS = (128, 2048)
ANSWERS = (64, 512)


class Case(NamedTuple):
    q_lat: torch.Tensor
    q_rope: torch.Tensor
    c: torch.Tensor
    kr: torch.Tensor
    pv: torch.Tensor
    scale: float


def chat_positions(rows: int, t: int, seed: int) -> List[int]:
    """Rows' positions as the chat mix leaves them, at most ``t - 1``."""
    rng = np.random.default_rng(seed)
    prompt = np.exp(rng.uniform(np.log(PROMPTS[0]), np.log(PROMPTS[1]),
                                rows)).astype(np.int64)
    answer = rng.integers(ANSWERS[0], ANSWERS[1] + 1, rows)
    done = (rng.uniform(0, 1, rows) * answer).astype(np.int64)
    return [int(p) for p in np.minimum(prompt + done, t - 1)]


def boundary_positions(t: int, chunk: int) -> List[int]:
    """0, each split edge less and plus one and itself, and ``t - 1``."""
    out = [0]
    for edge in range(chunk, t, chunk):
        out += [edge - 2, edge - 1, edge, edge + 1]
    return sorted({p for p in out + [t - 1] if 0 <= p < t})


def case(rows, heads, c_width, r_width, t, positions, *, scale, device,
         dtype=torch.bfloat16, cache_dtype=None, strided=False,
         seed=0) -> Case:
    """A core's inputs drawn from ``seed`` on ``device``: queries N(0,
    0.25), latent and keys N(0, 1) (an RMS-normed latent's size), so that
    scores spread over a few units; ``strided``: ``c`` and ``kr`` are
    views of one (rows, t, C + R) buffer."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, std=1.0, kind=dtype):
        return (torch.randn(shape, generator=g, device=device) * std).to(
            kind)

    cache_dtype = cache_dtype or dtype
    if strided:
        buf = draw(rows, t, c_width + r_width, kind=cache_dtype)
        c, kr = buf[..., :c_width], buf[..., c_width:]
    else:
        c = draw(rows, t, c_width, kind=cache_dtype)
        kr = draw(rows, t, r_width, kind=cache_dtype)
    return Case(draw(rows, heads, c_width, std=0.5),
                draw(rows, heads, r_width, std=0.5), c, kr,
                torch.as_tensor(positions, dtype=torch.int64, device=device),
                scale)


def plain(k: Case) -> torch.Tensor:
    """The plain core on the case: (B, H, C) in the queries' type."""
    return attention.mla_attend(k.q_lat[:, None], k.q_rope[:, None], k.c,
                                k.kr, k.pv, k.scale)[:, 0]


def exact(k: Case, rows_at_once: int = 16) -> torch.Tensor:
    """The core in float64 on the same rounded operands (no rounding of
    the probabilities or the context), a few rows at a time."""
    f64, dt = torch.float64, k.q_lat.dtype
    outs = []
    for b0 in range(0, k.q_lat.shape[0], rows_at_once):
        sl = slice(b0, b0 + rows_at_once)
        c = k.c[sl].to(dt).to(f64)
        sc = (torch.einsum("bhc,btc->bht", k.q_lat[sl].to(f64), c)
              + torch.einsum("bhr,btr->bht", k.q_rope[sl].to(f64),
                             k.kr[sl].to(dt).to(f64))) * k.scale
        keys = torch.arange(c.shape[1], device=c.device)
        live = keys[None, :] <= k.pv[sl, None]
        sc = sc.masked_fill(~live[:, None, :], float("-inf"))
        outs.append(torch.einsum("bht,btc->bhc", torch.softmax(sc, -1), c))
    return torch.cat(outs)


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative L2 distance of each (row, head) vector of ``a`` from
    ``b``'s."""
    a, b = a.double(), b.double()
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def kernel(k: Case, split=None) -> torch.Tensor:
    """The kernel on the case: ``ops.attend``, or with ``split`` (splits,
    keys a split) in place of ``plan``'s."""
    if split is None:
        return ops.attend(k.q_lat, k.q_rope, k.c, k.kr, k.pv, k.scale)
    return ops._launch(k.q_lat, k.q_rope, k.c, k.kr, k.pv, k.scale, split)


def compare(k: Case, split=None) -> Dict[str, float]:
    """The kernel against the plain core and both against ``exact``:
    the largest relative L2 distance of a (row, head) context vector, and
    the whole contexts' relative L2 errors."""
    got = kernel(k, split)
    want = plain(k)
    truth = exact(k)
    whole = lambda a: float((a.double() - truth).norm() / truth.norm())
    return {"kernel_vs_plain_max": float(_rel(got, want).max()),
            "kernel_err": whole(got), "plain_err": whole(want),
            "finite": bool(torch.isfinite(got).all())}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after ``warmup`` (CUDA
    events around the run)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 20) -> float:
    """Mean host microseconds to issue ``fn`` (no synchronise inside the
    loop: the card is still working when the host is done)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def time_core(k: Case, reps: int = 20, plain_reps: int = 5,
              split=None) -> Dict[str, float]:
    """Kernel and plain ms a call (CUDA events), the kernel's bound (ms)
    and its share of it, for the case's positions; the host's issue of a
    kernel call and of a plain call (us).  ``split`` as ``kernel``'s."""
    heads, c_width = k.q_lat.shape[1:]
    pv = k.pv.tolist()
    shape = (heads, c_width, k.q_rope.shape[2], k.c.shape[1])
    bound = 1e3 * ops.bound_seconds(pv, *shape)
    flops, nbytes = ops.work(pv, *shape)
    def run():
        return kernel(k, split)

    k_ms = time_ms(run, reps)
    p_ms = time_ms(lambda: plain(k), plain_reps, warmup=1) \
        if plain_reps else float("nan")
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "kernel_host_us": host_us(run),
            "plain_host_us": host_us(lambda: plain(k), plain_reps)
            if plain_reps else float("nan"),
            "bound_by": "bytes" if nbytes / ops.HBM_BYTES_PER_S
            >= flops / ops.PEAK_FLOPS else "operations",
            "share": bound / k_ms}
