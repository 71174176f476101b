"""The port's LM serving engine against the reference's on the CPU.

The same requests, with prompts made from a numpy seed, go through the
reference ``ServeEngine`` (float32 cache) and the port's
(``device="cpu"``) over the same smoke-config parameters
(``params_from_reference``): the greedy tokens must be equal.  Also:
``_select`` equal on equal logits and seed (temperature, top-k), a queue
longer than the slots drains, a batched run equals each request served
alone, the engine refuses to guess a device, and the CPU ``serve_lm``
example ends in ``OK``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as L
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke
from repro_torch.examples import serve_lm
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine

CPU = torch.device("cpu")


def requests(cfg, n, seed=7, lens=(5, 9), max_new=(3, 6)):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, cfg.vocab, int(rng.choice(lens))).astype(
        np.int32), int(rng.integers(*max_new))) for rid in range(n)]


def serve(engine, reqs, cls):
    for rid, prompt, max_new in reqs:
        engine.submit(cls(rid=rid, prompt=prompt, max_new=max_new))
    done = engine.run_until_done()
    return {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("arch", ["repro-100m", "gemma2-27b"])
def test_greedy_tokens_match_reference_engine(arch):
    jcfg, jp, cfg, tp = L.model(arch)
    reqs = requests(cfg, 6)
    want = serve(JServeEngine(jp, jcfg, batch_size=4, max_len=32,
                              cache_dtype=jnp.float32), reqs, JRequest)
    got = serve(ServeEngine(tp, cfg, batch_size=4, max_len=32, device=CPU),
                reqs, Request)
    assert len(got) == 6 and got == want


@pytest.mark.parametrize("temperature,top_k,seed", [(1.0, 0, 0), (0.7, 5, 3),
                                                    (1.3, 1, 11)])
def test_select_matches_reference(temperature, top_k, seed):
    jcfg, jp, cfg, tp = L.model("repro-100m")
    kw = dict(batch_size=1, max_len=8, greedy=False, temperature=temperature,
              top_k=top_k, seed=seed)
    ref = JServeEngine(jp, jcfg, **kw)
    eng = ServeEngine(tp, cfg, device=CPU, **kw)
    rows = np.random.default_rng(seed).standard_normal(
        (20, cfg.vocab)).astype(np.float32) * 3
    assert [eng._select(r) for r in rows] == [ref._select(r) for r in rows]
    eng.greedy = ref.greedy = True
    assert eng._select(rows[0]) == ref._select(rows[0]) == int(
        np.argmax(rows[0]))


def test_queue_overflow_drains_and_batched_equals_single():
    cfg = get_smoke("internlm2-20b")
    params = init_params(cfg, seed=5, device="cpu")
    reqs = requests(cfg, 7, seed=1, lens=(3, 6, 11), max_new=(2, 7))
    eng = ServeEngine(params, cfg, batch_size=2, max_len=24, device=CPU)
    batched = serve(eng, reqs, Request)
    assert sorted(batched) == list(range(7))
    assert not eng.queue and all(s is None for s in eng.slots)
    assert all(len(batched[rid]) == max_new for rid, _, max_new in reqs)
    for req in reqs:
        alone = serve(ServeEngine(params, cfg, batch_size=1, max_len=24,
                                  device=CPU), [req], Request)
        assert alone[req[0]] == batched[req[0]], req[0]


def test_eos_and_max_len_free_the_slot():
    cfg = get_smoke("repro-100m")
    params = init_params(cfg, seed=2, device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    first = serve(ServeEngine(params, cfg, 1, 16, device=CPU),
                  [(0, prompt, 6)], Request)[0]
    eng = ServeEngine(params, cfg, 1, 16, device=CPU)
    eng.submit(Request(rid=0, prompt=prompt, max_new=6, eos=first[2]))
    # The prefill's token is not checked against eos; each decoded one is.
    stop = next(i for i in range(1, 6) if first[i] == first[2])
    assert [r.out for r in eng.run_until_done()] == [first[:stop + 1]]
    # max_len: the slot frees once the next write position reaches it - 1.
    eng = ServeEngine(params, cfg, 1, 8, device=CPU)
    eng.submit(Request(rid=0, prompt=prompt, max_new=50))
    (done,) = eng.run_until_done()
    assert len(done.out) == 3 and eng.pos[0] == 0


def test_engine_needs_a_card_or_an_explicit_device(monkeypatch):
    cfg = get_smoke("repro-100m")
    params = init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, 2, 16)
    with pytest.raises(NotImplementedError, match="cannot place a cross "
                       "cache"):
        ServeEngine(params, get_smoke("seamless-m4t-medium"), 2, 16,
                    device=CPU)


def test_serve_lm_example_cpu_ends_ok(capsys):
    done = serve_lm.main(["--device", "cpu", "--arch", "gemma2-27b"])
    assert len(done) == 10
    assert capsys.readouterr().out.rstrip().endswith("OK")
