"""Training loop: the train step (gradients accumulated over microbatches,
then a clipped AdamW update) and a ``Trainer`` with resumable
checkpoints, as the reference's (``repro/train/loop.py``) on one device.

Fault tolerance: an async checkpoint of ``{"params", "opt": {"m", "v",
"step"}}`` every ``ckpt_every`` steps, under the reference's leaf keys and
on-disk format, so either package resumes the other's; on (re)start the
``Trainer`` restores ``latest_step`` and replays the counter-based data
stream from there.  Sharding over a mesh (``mesh``, ``rules``) is not
ported yet (ROADMAP §1, item 11f).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import common as cm
from repro_torch.models import init_params, lm, loss_fn
from repro_torch.optim import AdamW, cosine_schedule

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
            g = [t.grad.to(torch.float32) if t.grad is not None
                 else torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for t in live]
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


class Trainer:
    """The training loop on one device (``device=None``: the card): seeded
    init, data, step, checkpoints."""

    def __init__(self, model_cfg, tcfg: TrainConfig, mesh=None, rules=None,
                 *, device=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "Trainer(mesh=, rules=): sharded training is not ported to "
                "repro_torch yet (ROADMAP §1 item 11f); the port trains on "
                "one device")
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.device = cm.device_or_card(device)
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
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.start_step = last
        log.info("resumed from step %d", last)

    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self, steps: Optional[int] = None) -> Dict[str, list]:
        steps = steps or self.tcfg.steps
        history = {"loss": [], "step_time": []}
        for s in range(self.start_step, steps):
            t0 = time.perf_counter()
            batch = self._device_batch(s)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {s}")
            history["loss"].append(loss)
            history["step_time"].append(time.perf_counter() - t0)
            if self.manager and (s + 1) % self.tcfg.ckpt_every == 0:
                self.manager.save_async(
                    s + 1, {"params": self.params, "opt": self.opt_state})
            if (s + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", s + 1, loss,
                         1e3 * history["step_time"][-1])
        if self.manager:
            self.manager.wait()
        return history
