"""Batched LM serving engine: slot-based continuous batching over a fixed
decode batch.

The engine keeps ``batch_size`` decode slots.  Incoming requests are
prefilled one at a time and their caches written into a free slot; every
``step()`` advances all live slots by one token with one batched
``decode_step`` at per-row positions.  Finished requests (EOS or
max-new-tokens) free their slot for the queue.  Token selection (greedy,
or temperature / top-k sampling from a seeded numpy generator) runs on
the host, as in the reference.

``device=None`` serves on the card and raises when there is none; pass
``device="cpu"`` to serve on the CPU.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int = 16
    eos: int = -1                   # -1: never stop early
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, params, cfg, batch_size: int, max_len: int,
                 cache_dtype=torch.float32, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0, seed: int = 0,
                 device=None):
        if cfg.enc_layers:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder is not served by "
                f"ServeEngine: the reference's engine cannot place a cross "
                f"cache (its init_cache gives cache['cross'] length 0, and "
                f"the slot write fails on the first request); serve it "
                f"through models.lm.prefill and decode_step, as the "
                f"reference does (an engine with a cross cache per slot is "
                f"a feature beyond the reference, ROADMAP)")
        self.device = cm.device_or_card(device)
        for leaf in lm.tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"parameters live on {leaf.device}, the "
                                 f"engine serves on {self.device}")
        self.params, self.cfg = params, cfg
        self.bs, self.max_len = batch_size, max_len
        self.greedy = greedy
        self.temperature, self.top_k = temperature, top_k
        self._rng = np.random.default_rng(seed)
        self.cache = init_cache(cfg, batch_size, max_len, cache_dtype,
                                device=self.device)
        self.cache_dtype = cache_dtype
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros(batch_size, np.int32)     # next write position
        self.last_tok = np.zeros(batch_size, np.int32)
        self.queue: deque = deque()
        self.finished: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _write_slot_cache(self, slot: int, src_cache):
        """Copy a single-request prefill cache into batch slot ``slot``,
        every subtree of it.  Each leaf's batch axis is where its family
        puts it (axis 1 for ``(layers, B, ...)`` stacks, axis 2 for
        zamba2's ``(groups, period, B, ...)`` SSM states): the first axis
        whose extent is the engine's batch here and 1 in the request's
        cache, with equal extents before it."""
        dst_leaves = list(lm.tree_leaves(self.cache))
        src_leaves = list(lm.tree_leaves(src_cache))
        if len(dst_leaves) != len(src_leaves):
            raise ValueError("the prefill cache's tree is not the engine's")
        for dst, src in zip(dst_leaves, src_leaves):
            axis = next(a for a in range(dst.dim())
                        if dst.shape[a] == self.bs and src.shape[a] == 1
                        and dst.shape[:a] == src.shape[:a])
            dst.select(axis, slot).copy_(src.select(axis, 0))

    def _select(self, logits_row: np.ndarray) -> int:
        """Greedy argmax or temperature/top-k sampling."""
        if self.greedy:
            return int(np.argmax(logits_row))
        lg = logits_row.astype(np.float64) / max(self.temperature, 1e-6)
        if self.top_k:
            kth = np.partition(lg, -self.top_k)[-self.top_k]
            lg = np.where(lg >= kth, lg, -np.inf)
        p = np.exp(lg - lg.max())
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        return logits.to(torch.float32).cpu().numpy()

    def _fill_free_slots(self):
        for i in range(self.bs):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                batch = {"tokens": torch.as_tensor(
                    np.asarray(req.prompt)[None, :], dtype=torch.int64,
                    device=self.device)}
                last_logits, rcache = prefill(self.params, self.cfg, batch,
                                              max_len=self.max_len,
                                              cache_dtype=self.cache_dtype)
                self._write_slot_cache(i, rcache)
                tok = self._select(self._host(last_logits[0]))
                req.out.append(tok)
                self.slots[i] = req
                self.pos[i] = len(req.prompt)
                self.last_tok[i] = tok

    def step(self) -> int:
        """One batched decode step over all live slots (per-row positions);
        returns the number of live slots advanced."""
        self._fill_free_slots()
        live = [i for i in range(self.bs) if self.slots[i] is not None]
        if not live:
            return 0
        toks = torch.as_tensor(self.last_tok, dtype=torch.int64,
                               device=self.device)
        pos = torch.as_tensor(self.pos, dtype=torch.int64, device=self.device)
        logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                         toks, pos)
        lg = self._host(logits)
        for i in live:
            tok = self._select(lg[i])
            req = self.slots[i]
            req.out.append(tok)
            self.last_tok[i] = tok
            self.pos[i] += 1
            if (tok == req.eos or len(req.out) >= req.max_new
                    or self.pos[i] >= self.max_len - 1):
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self.pos[i] = 0
        return len(live)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
