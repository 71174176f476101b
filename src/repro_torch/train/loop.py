"""Training loop: the train step (gradients accumulated over microbatches,
then a clipped AdamW update) and a ``Trainer`` with resumable
checkpoints, as the reference's (``repro/train/loop.py``).

Sharding: ``Trainer(mesh=, rules=)`` places the parameters and the
optimizer state on a ``DeviceMesh`` as DTensors placed by the sharding
rules from their logical axes (``parallel.context.distribute``), each
batch's rows over the batch axes, and runs the step under ``use_rules``
and ``implicit_replication()``
(one process per rank: ``torchrun``).  Without a mesh it is the
one-device trainer.

Fault tolerance: an async checkpoint of ``{"params", "opt": {"m", "v",
"step"}}`` every ``ckpt_every`` steps, under the reference's leaf keys and
on-disk format, so either package resumes the other's (on a mesh, rank 0
writes the full tensors); on (re)start the ``Trainer`` restores
``latest_step`` onto the current mesh's placements -- which may differ
from the mesh that wrote it (elastic re-scale) -- and replays the
counter-based data stream from there.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import checkpoint as ckpt_lib
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import common as cm
from repro_torch.models import init_params, lm, loss_fn
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import Rules
from repro_torch.parallel.context import distribute, use_rules

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    seq_len: int = 512
    global_batch: int = 8
    microbatches: int = 1        # gradient accumulation factor
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    opt_state_dtype: str = "float32"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10


def make_train_step(cfg, opt: AdamW, microbatches: int = 1) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss.backward()`` on each of ``microbatches`` equal row
    slices of the batch, the gradients accumulated in float32 and averaged
    (the loss too; the other metrics are the last microbatch's), then
    ``opt.update``.  ``params`` are not modified."""

    def step_fn(params, opt_state, batch):
        live = [t.detach().requires_grad_(True)
                for t in lm.tree_leaves(params)]
        tree = lm.tree_unflatten(params, live)
        b = next(iter(batch.values())).shape[0]
        per = b // microbatches
        grads = loss = None
        for i in range(microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            mb_loss, metrics = loss_fn(tree, cfg, mb)
            mb_loss.backward()
            g = [_placed_like(t.grad.to(torch.float32), t)
                 if t.grad is not None
                 else torch.zeros_like(t, dtype=torch.float32)
                 for t in live]
            for t in live:
                t.grad = None
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
            loss = (mb_loss.detach() if loss is None
                    else loss + mb_loss.detach())
        if microbatches > 1:
            grads = [x / microbatches for x in grads]
            loss = loss / microbatches
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, om = opt.update(
            lm.tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, dict(metrics, **om, loss=loss)

    return step_fn


def _placed_like(g, p):
    """A DTensor gradient on its parameter's placement (the gradient
    reduction an FSDP or tensor-parallel step makes), so the update keeps
    every parameter where the rules put it; a tensor as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


class Trainer:
    """The training loop: seeded init, data, step, checkpoints.  On one
    device (``device=None``: the card), or with ``mesh`` (a
    ``DeviceMesh``; this process is one of its ranks) sharded by ``rules``
    (default ``Rules(mesh)``) on the mesh's device type."""

    def __init__(self, model_cfg, tcfg: TrainConfig, mesh=None,
                 rules: Optional[Rules] = None, *, device=None):
        if rules is not None and mesh is None:
            raise ValueError("Trainer(rules=) needs the mesh it maps to")
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.rules = (rules or Rules(mesh, seq_parallel=model_cfg.seq_parallel)
                      if mesh is not None else None)
        self.device = cm.device_or_card(
            device if device is not None or mesh is None
            else mesh.device_type)
        self.opt = AdamW(
            lr=cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps),
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
            state_dtype=tcfg.opt_state_dtype)
        self.data = SyntheticLM(
            vocab=model_cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed,
            frames_dim=model_cfg.d_model if model_cfg.frontend == "frames"
            else 0)
        self.manager = (ckpt_lib.CheckpointManager(tcfg.ckpt_dir)
                        if tcfg.ckpt_dir else None)
        self.params = init_params(model_cfg, seed=tcfg.seed,
                                  device=self.device)
        if mesh is not None:
            self.param_axes = lm.param_axes(model_cfg)
            self.params = self._distribute(self.params)
        self.opt_state = self.opt.init(self.params)
        self.start_step = 0
        self._maybe_resume()
        self.step_fn = make_train_step(model_cfg, self.opt,
                                       tcfg.microbatches)

    # -- fault tolerance -----------------------------------------------------
    def _maybe_resume(self):
        if not self.manager:
            return
        last = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return
        restored = ckpt_lib.restore(
            self.tcfg.ckpt_dir, last,
            {"params": self.params, "opt": self.opt_state})
        self.params = self._distribute(restored["params"])
        self.opt_state = restored["opt"]
        if self.mesh is not None:
            self.opt_state.update(m=self._distribute(restored["opt"]["m"]),
                                  v=self._distribute(restored["opt"]["v"]))
        self.start_step = last
        log.info("resumed from step %d", last)

    # -- the mesh -------------------------------------------------------------
    def _distribute(self, tree):
        """A tree shaped like the parameters, placed like them on the mesh
        (every rank holds the whole tree and keeps its own shards); as it
        is without a mesh."""
        if self.mesh is None:
            return tree
        return distribute(tree, self.param_axes, self.rules)

    def _scope(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(use_rules(self.rules))
        stack.enter_context(implicit_replication())
        return stack

    def _host_state(self):
        """The checkpointed state with every DTensor gathered whole (a
        collective: every rank calls it)."""
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        return {"params": lm.tree_map(full, self.params),
                "opt": lm.tree_map(full, self.opt_state)}

    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.batch_at(step).items()}
        if self.mesh is None:
            return batch
        return distribute(batch, {k: ("batch",) + (None,) * (v.dim() - 1)
                                  for k, v in batch.items()}, self.rules)

    def run(self, steps: Optional[int] = None) -> Dict[str, list]:
        steps = steps or self.tcfg.steps
        history = {"loss": [], "step_time": []}
        for s in range(self.start_step, steps):
            t0 = time.perf_counter()
            batch = self._device_batch(s)
            with self._scope():
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if isinstance(loss, DTensor)
                         else loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {s}")
            history["loss"].append(loss)
            history["step_time"].append(time.perf_counter() - t0)
            if self.manager and (s + 1) % self.tcfg.ckpt_every == 0:
                state = (self._host_state() if self.mesh is not None else
                         {"params": self.params, "opt": self.opt_state})
                if self.mesh is None or dist.get_rank() == 0:
                    self.manager.save_async(s + 1, state)
            if (s + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", s + 1, loss,
                         1e3 * history["step_time"][-1])
        if self.manager:
            self.manager.wait()
            if self.mesh is not None:
                dist.barrier()      # rank 0's checkpoints are on disk
        return history
