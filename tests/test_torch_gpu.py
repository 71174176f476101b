"""Card-only tests of the port's CUDA kernel (marker ``gpu``).

    python -m pytest -q -m gpu tests/test_torch_gpu.py    # on the card

The parity sweeps of ``chip_smoke.py`` at a small lattice -- periodic,
extended-shard and precomputed-RNG mode -- the kernel against its plain
version on the card, bit for bit; the single-device and sharded entry
points against their plain runs on the CPU.  Whether a card is present is
decided inside the ``cuda`` fixture, so every worker collects the same
tests; without a card they skip.
"""
import pytest
import torch

from repro_torch.core import distributed, prng, rulespec
from repro_torch.kernels.fhp_step import check, opcount, ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", check.CASES, ids=str)
def test_kernel_matches_plain_version(cuda, case):
    bad = check.run_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", check.CASES, ids=str)
def test_extended_kernel_matches_plain_version(cuda, case):
    bad = check.run_extended_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", check.K2_CASES, ids=str)
def test_precomputed_rng_kernel_matches_plain_version(cuda, case):
    bad = check.run_k2_case(case, cuda, h=70, wd=31)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("case", [c for c in check.CASES if c.lanes == 3],
                         ids=str)
def test_kernel_matches_plain_version_16_byte_rows(cuda, case):
    # Wd % 4 == 0: the tiles' apron loads and stores take 16-byte chunks.
    for run_case in (check.run_case, check.run_extended_case):
        bad = run_case(case, cuda, h=70, wd=32)
        assert not bad, "\n".join(bad)


@pytest.mark.parametrize("overlap,static", [(False, False), (True, False),
                                            (True, True)])
def test_sharded_path_counts_launches(cuda, overlap, static):
    # A 2 x 2 mesh of four slots on the one card against the same mesh of
    # CPU slots (the plain version) and the single-device plain run.
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 8, 64, 40),
                          dtype=torch.int32)
    words[:, 7] = words[0, 7]
    kw = dict(depth=4, steps_per_launch=4, p_force=0.05, variant="fhp3",
              overlap=overlap, static_solid=static, batched=True,
              moments_every=2)
    run = distributed.make_run(
        distributed.make_mesh((2, 2), ("data", "model"), cuda), 8, **kw)
    ops.LAUNCHES.clear()
    out, mom = run(words.to(cuda), 3)
    assert ops.launches_total() == 2 * 4 * (5 if overlap else 1)
    want, wmom = distributed.make_run(
        distributed.make_mesh((2, 2), ("data", "model"), "cpu"), 8,
        **kw)(words, 3)
    assert torch.equal(out.cpu(), want) and torch.equal(mom.cpu(), wmom)
    single_run, _ = distributed.make_ensemble_run(
        None, 8, variant="fhp3", p_force=0.05, steps_per_launch=4,
        moments_every=2)
    single, smom = single_run(words, 3)
    assert torch.equal(want, single)
    assert torch.equal(wmom, smom[..., [r for r, n in enumerate(
        rulespec.moment_spec(rulespec.get_rule("fhp3")).names)
        if n != "solid" or not static]])


def test_main_path_counts_launches(cuda):
    words = torch.randint(0, 2 ** 31 - 1, (2, 8, 64, 40), dtype=torch.int32)
    planes = words.to(cuda)
    run, sharding = distributed.make_ensemble_run(
        None, 19, variant="fhp3", p_force=0.05, steps_per_launch=4,
        moments_every=4)
    assert sharding is None
    ops.LAUNCHES.clear()
    out, mom = run(planes, 3)
    assert ops.launches_total() == 5          # 4 launches of 4 steps + 1 of 3
    want, wmom = run(words, 3)        # plain version on the CPU
    assert torch.equal(out.cpu(), want)
    assert torch.equal(mom.cpu(), wmom)
    assert mom.shape == (2, 4, rulespec.moment_spec(
        rulespec.get_rule("fhp3")).n_moments)



def test_sharded_path_on_distinct_cards(cuda):
    # The same 2 x 2 mesh with one card per slot: halo slices cross
    # between cards; the result equals four slots on one card.
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 8, 256, 64),
                          dtype=torch.int32)
    kw = dict(depth=8, steps_per_launch=8, p_force=0.05, overlap=True,
              moments_every=4)
    cards = [torch.device("cuda", i) for i in range(4)]
    run, sharding = distributed.make_ensemble_run(
        distributed.make_mesh((2, 2), ("data", "model"), cards), 16, **kw)
    assert {d.index for row in sharding.devices for d in row} == {0, 1, 2, 3}
    ops.LAUNCHES.clear()
    out, mom = run(words.to(cuda), 3)
    assert ops.launches_total() == 2 * 4 * 5
    one, _ = distributed.make_ensemble_run(
        distributed.make_mesh((2, 2), ("data", "model"), cuda), 16, **kw)
    want, wmom = one(words.to(cuda), 3)
    assert torch.equal(out, want) and torch.equal(mom, wmom)


def test_compiled_word_step_is_counted(cuda):
    # The probes compile to straight-line code (counts raises otherwise).
    c = opcount.counts(prng.quantize_p(0.03))
    assert c["step"]["alu"] > 50 and c["step"]["fma"] > 0
    assert c["terms"]["popc"] == len(rulespec.moment_spec(
        rulespec.get_rule("fhp2")).terms)


@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_serve_engine_on_card_matches_cpu(cuda, mesh, tmp_path):
    # The serve engine with its lanes on the card (single device, or a
    # 2 x 2 mesh of slots on it) against the same engine on the CPU, a
    # bitflip rolled back in both: equal results, frames and detections.
    from repro_torch.serve import CAServeEngine, Fault, FaultInjector, SimJob

    def serve(device, d):
        kw = {}
        if mesh:
            kw["mesh"] = distributed.make_mesh((2, 2), ("data", "model"),
                                               device)
        eng = CAServeEngine(
            height=64, width=512, slots=2, depth=4, steps_per_launch=4,
            device=device, ckpt_dir=str(tmp_path / d), ckpt_every=1,
            injector=FaultInjector([Fault(kind="bitflip", round=2,
                                          rule="fhp3", bits=3, seed=1)]),
            **kw)
        for rid in range(3):
            sc, ov = (("bml_city", {}) if rid == 1
                      else ("cylinder", {"variant": "fhp3"}))
            eng.submit(SimJob(rid=rid, scenario=sc, steps=16, frame_every=8,
                              overrides=dict(ov, seed=rid)))
        ops.LAUNCHES.clear()
        eng.drain()
        return eng, ops.launches_total()

    card, launches = serve(cuda, "card")
    host, _ = serve(torch.device("cpu"), "cpu")
    assert launches > 0 and card.detections == host.detections != []
    for rid, job in host.jobs.items():
        assert (card.jobs[rid].result == job.result).all(), rid
        assert card.jobs[rid].frames == job.frames, rid
