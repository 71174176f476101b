"""``Trainer(mesh=, rules=)`` on a (4, 2) ``DeviceMesh`` of 8 gloo ranks
(``torchrun``, CPU) against the one-device trainers: repro-100m's smoke
losses within 1e-5 of the port's one-device ``Trainer`` (both from the
port's seeded init) and of the reference's (the sharded run resumes the
reference's step-0 checkpoint, so both start from its init), and
deepseek-v3's smoke config (4 dispatch groups, one per data shard) within
1e-5 of the port's one-device run under the same grouping (rules
installed on a stand-in (4, 2) mesh)."""
import textwrap
import types

import jax
import numpy as np
import pytest

from _torch_sharded import results, torchrun
from repro import checkpoint as jckpt
from repro.configs import get_smoke as jget_smoke
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.configs import get_smoke
from repro_torch.parallel import Rules
from repro_torch.parallel.context import use_rules
from repro_torch.train import TrainConfig, Trainer

TC = dict(seq_len=32, global_batch=8, steps=3, lr=1e-3, warmup=2,
          log_every=100)

SCRIPT = textwrap.dedent("""
    import json, logging, sys
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import TrainConfig, Trainer

    logging.disable(logging.WARNING)
    dist.init_process_group("gloo")
    mesh = make_test_mesh(device_type="cpu")
    runs = (("repro-100m", None), ("reference-init", sys.argv[1]),
            ("deepseek-v3-671b", None))
    for name, ckpt in runs:
        arch = "repro-100m" if ckpt else name
        tr = Trainer(get_smoke(arch), TrainConfig(ckpt_dir=ckpt, **%r),
                     mesh=mesh)
        shard = tr.params["embed"]
        hist = tr.run()
        if dist.get_rank() == 0:
            print("RESULT " + json.dumps({
                "arch": name, "loss": hist["loss"],
                "embed": [p.dim if p.is_shard() else None
                          for p in shard.placements],
                "local": list(shard.to_local().shape)}))
    dist.destroy_process_group()
""" % TC)


@pytest.fixture(scope="module")
def reference():
    """The reference's one-device trainer (its own init) before a step."""
    return JTrainer(jget_smoke("repro-100m"), JTrainConfig(**TC))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("sharded")
    jckpt.save(str(d / "ckpt"), 0, {"params": reference.params,
                                    "opt": reference.opt_state})
    (d / "train.py").write_text(SCRIPT)
    return {r["arch"]: r for r in results(
        torchrun([str(d / "train.py"), str(d / "ckpt")]))}


def test_sharded_repro_100m_matches_one_device_trainers(sharded,
                                                        reference):
    got = sharded["repro-100m"]
    # The embedding (vocab 512, embed 128): vocab over model, embed over
    # data (FSDP).
    assert got["embed"] == [1, 0]
    assert got["local"] == [256, 32]
    port = Trainer(get_smoke("repro-100m"), TrainConfig(**TC),
                   device="cpu").run()["loss"]
    np.testing.assert_allclose(got["loss"], port, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sharded["reference-init"]["loss"],
                               reference.run()["loss"], rtol=0, atol=1e-5)


def test_sharded_deepseek_matches_one_device_under_the_same_grouping(
        sharded):
    got = sharded["deepseek-v3-671b"]["loss"]
    stand_in = Rules(types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                           shape=(4, 2)))
    with use_rules(stand_in):               # 4 dispatch groups
        want = Trainer(get_smoke("deepseek-v3-671b"), TrainConfig(**TC),
                       device="cpu").run()["loss"]
    one = Trainer(get_smoke("deepseek-v3-671b"), TrainConfig(**TC),
                  device="cpu").run()["loss"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(got[-1] - one[-1]) > 1e-5    # one group: another run
    assert jax.devices()                    # (the reference stays usable)
