"""The port's LM serving engine against the reference's on the CPU for
the experts/MLA and SSM/hybrid families: deepseek-v3-671b,
llama4-scout-17b-a16e, mamba2-2.7b and zamba2-2.7b at their smoke
configs, in float32, from one tree given to both packages (helpers in
``tests/_torch_lm.py``).  The same requests go through the reference
``ServeEngine`` (float32 cache) and the port's (``device="cpu"``): the
greedy tokens must be equal.  The prompts share one length, so the
reference engine compiles one prefill per arch.  The CPU ``serve_lm``
example ends ``OK`` for each arch.  (Split from ``test_torch_lm_moe.py``
and ``test_torch_lm_ssm.py`` so that no file passes 60 s on one core.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.examples import serve_lm
from repro_torch.serve import Request, ServeEngine

ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e", "mamba2-2.7b",
         "zamba2-2.7b")


def _requests(cfg, n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, cfg.vocab, 9).astype(np.int32),
             int(rng.integers(3, 6))) for rid in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_engine(arch):
    jcfg, jp, cfg, tp = L.model(arch, ref_init=False)
    reqs = _requests(cfg)
    out = []
    for eng, cls in ((JServeEngine(jp, jcfg, batch_size=4, max_len=32,
                                   cache_dtype=jnp.float32), JRequest),
                     (ServeEngine(tp, cfg, batch_size=4, max_len=32,
                                  device=torch.device("cpu")), Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(cls(rid=rid, prompt=prompt, max_new=max_new))
        out.append({r.rid: list(r.out) for r in eng.run_until_done()})
    assert len(out[1]) == len(reqs) and out[1] == out[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_example_cpu_ends_ok(arch, capsys):
    done = serve_lm.main(["--device", "cpu", "--arch", arch])
    assert len(done) == 10
    assert capsys.readouterr().out.rstrip().endswith("OK")
