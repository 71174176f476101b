"""Elastic re-scale of the port's sharded trainer, and its launcher, on 8
gloo ranks (``torchrun``, CPU): a checkpoint written under a (4, 2)
``DeviceMesh`` (rank 0 writes full tensors, the on-disk format of the
one-device trainer) resumes on a (2, 4) mesh with every leaf on the new
mesh's placements, and training continues as an uninterrupted (4, 2) run
does (the counterpart of ``tests/test_elastic.py``); ``launch/train.py
--mesh test`` trains the smoke config on the (4, 2) mesh."""
import textwrap

import numpy as np

from _torch_sharded import results, torchrun

SCRIPT = textwrap.dedent("""
    import json, logging, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.train import TrainConfig, Trainer

    logging.disable(logging.WARNING)
    dist.init_process_group("gloo")
    cfg = get_smoke("repro-100m")
    a = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    tc = lambda steps, d=None: TrainConfig(
        seq_len=32, global_batch=8, steps=steps, lr=1e-3, warmup=2,
        ckpt_dir=d, ckpt_every=2, log_every=100)

    whole = Trainer(cfg, tc(4), mesh=a)
    h_whole = whole.run()
    Trainer(cfg, tc(2, sys.argv[1]), mesh=a).run()     # checkpoint at 2
    resumed = Trainer(cfg, tc(4, sys.argv[1]), mesh=b)
    start = resumed.start_step
    w = resumed.params["layers"]["0_a"]["ffn"]["wg"]
    h_resumed = resumed.run()
    full = lambda tr: [t.full_tensor().numpy().tolist()
                       for t in lm.tree_leaves(tr.params)][:3]
    fa, fb = full(whole), full(resumed)
    if dist.get_rank() == 0:
        print("RESULT " + json.dumps({
            "start": start, "whole": h_whole["loss"],
            "resumed": h_resumed["loss"], "mesh": list(w.device_mesh.shape),
            "local": list(w.to_local().shape), "a": fa, "b": fb}))
    dist.destroy_process_group()
""")


def test_checkpoint_on_4x2_resumes_on_2x4(tmp_path):
    (tmp_path / "elastic.py").write_text(SCRIPT)
    (r,) = results(torchrun([str(tmp_path / "elastic.py"),
                             str(tmp_path / "ckpt")]))
    assert r["start"] == 2
    # (layers, embed, d_ff) = (2, 128, 256): embed over data (2), d_ff over
    # model (4) on the new mesh.
    assert r["mesh"] == [2, 4] and r["local"] == [2, 64, 64]
    np.testing.assert_allclose(r["resumed"], r["whole"][2:], rtol=0,
                               atol=1e-5)
    for x, y in zip(r["a"], r["b"]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5,
                                   atol=1e-6)


def test_train_launcher_on_the_test_mesh():
    r = torchrun(["-m", "repro_torch.launch.train", "--smoke", "--mesh",
                  "test", "--device", "cpu", "--steps", "3", "--seq-len",
                  "32"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("final loss")]
    assert len(lines) == 1 and "(first " in lines[0]      # rank 0 only
