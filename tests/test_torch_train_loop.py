"""The port's ``Trainer`` on the CPU: the reference's own Trainer tests
(``tests/test_train_serve.py``) on the port's, a run started by one
package and resumed by the other from its checkpoint, and the training
CLIs.

Cross-package resume: a ``Trainer`` of one package runs steps 0-2 and
checkpoints step 3 (``{"params", "opt": {"m", "v", "step"}}`` under the
reference's leaf keys); the other package's ``Trainer`` resumes from that
checkpoint and runs steps 3-5, and its parameters must lie within 1e-5
of the first package's own resumed run (fp reassociation between XLA and
PyTorch only).  The reference's own tolerance (rtol 1e-6, atol 1e-7)
holds the port's interrupted run against its straight one.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.configs import get_smoke
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import TrainConfig, Trainer

CPU = "cpu"


def test_train_loss_decreases_and_resumes_bitwise(tmp_path):
    cfg = get_smoke("repro-100m")
    tc = TrainConfig(seq_len=64, global_batch=8, steps=6, lr=1e-3,
                     warmup=2, ckpt_dir=str(tmp_path), ckpt_every=3,
                     log_every=100)
    tr = Trainer(cfg, tc, device=CPU)
    hist = tr.run()
    assert hist["loss"][-1] < hist["loss"][0]
    assert len(hist["step_time"]) == 6
    tr2 = Trainer(cfg, tc, device=CPU)        # picks up step-6 checkpoint
    assert tr2.start_step == 6
    for a, b in zip(lm.tree_leaves(tr.params), lm.tree_leaves(tr2.params)):
        assert torch.equal(a, b)
    for a, b in zip(lm.tree_leaves(tr.opt_state),
                    lm.tree_leaves(tr2.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_interrupted_resume_matches_uninterrupted(tmp_path):
    """Fault tolerance: crash at step 3, restart, finish 6 == straight 6."""
    cfg = get_smoke("repro-100m")
    kw = dict(seq_len=32, global_batch=4, steps=6, lr=1e-3, warmup=2,
              ckpt_every=3, log_every=100)
    straight = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path / "a"), **kw),
                       device=CPU)
    straight.run()
    tc_b = TrainConfig(ckpt_dir=str(tmp_path / "b"), **kw)
    Trainer(cfg, tc_b, device=CPU).run(steps=3)   # "crashes" after step 3
    resumed = Trainer(cfg, tc_b, device=CPU)
    assert resumed.start_step == 3
    resumed.run()
    for a, b in zip(lm.tree_leaves(straight.params),
                    lm.tree_leaves(resumed.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_microbatching_changes_nothing_semantically():
    cfg = get_smoke("repro-100m")
    kw = dict(seq_len=32, global_batch=8, steps=2, lr=1e-3, warmup=1,
              log_every=100)
    h1 = Trainer(cfg, TrainConfig(microbatches=1, **kw), device=CPU).run()
    h2 = Trainer(cfg, TrainConfig(microbatches=4, **kw), device=CPU).run()
    # same data, averaged grads: losses close (not bitwise: fp reassoc)
    assert abs(h1["loss"][0] - h2["loss"][0]) < 1e-2


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_from_the_other_package(tmp_path, first):
    cfg = get_smoke("repro-100m")
    kw = dict(seq_len=32, global_batch=4, steps=6, lr=1e-3, warmup=2,
              ckpt_every=3, log_every=100)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"

    def ref(d):
        return JTrainer(cfg, JTrainConfig(ckpt_dir=str(d), **kw))

    def port(d):
        return Trainer(cfg, TrainConfig(ckpt_dir=str(d), **kw), device=CPU)

    a, b = (ref, port) if first == "reference" else (port, ref)
    src, dst = ((ref_dir, port_dir) if first == "reference"
                else (port_dir, ref_dir))
    a(src).run(steps=3)                          # stopped after step 3
    shutil.copytree(src, dst)
    own, other = a(src), b(dst)
    assert own.start_step == other.start_step == 3
    own.run()
    other.run()
    got = {"reference": jax.tree.leaves, "port": lm.tree_leaves}
    for x, y in zip(got[first](own.params),
                    got["port" if first == "reference" else "reference"](
                        other.params)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


def test_trainer_refuses_a_mesh_and_stops_on_a_nonfinite_loss():
    cfg = get_smoke("repro-100m")
    tc = TrainConfig(seq_len=16, global_batch=2, steps=2, log_every=100)
    with pytest.raises(ValueError, match="needs the mesh"):
        Trainer(cfg, tc, rules=object(), device=CPU)
    tr = Trainer(cfg, tc, device=CPU)
    tr.params["final_norm"]["w"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="step 0"):
        tr.run()


def test_train_launcher_cpu(capsys):
    assert launch_train.main(["--smoke", "--steps", "3", "--seq-len", "32",
                              "--global-batch", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("final loss ") and "(first " in out
    with pytest.raises(SystemExit):
        launch_train.main(["--mesh", "test", "--device", "cpu"])


def test_train_lm_example_cpu_ends_ok(capsys):
    hist = train_lm.main(["--device", "cpu", "--steps", "30",
                          "--seq-len", "64"])
    assert len(hist["loss"]) == 30 and hist["loss"][-1] < hist["loss"][0]
    out = capsys.readouterr().out.rstrip().splitlines()
    assert out[-1] == "OK" and out[-2].startswith(
        "resume check: restart would continue from step 30 (>20)")
