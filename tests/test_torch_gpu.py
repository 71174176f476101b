"""Card-only tests of the port's CUDA kernel (marker ``gpu``).

    python -m pytest -q -m gpu tests/test_torch_gpu.py    # on the card

The parity sweep of ``chip_smoke.py`` at a small lattice: the kernel
against its plain version on the card, bit for bit.  Whether a card is
present is decided inside the ``cuda`` fixture, so every worker collects
the same tests; without a card they skip.
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


def test_main_path_counts_launches(cuda):
    words = torch.randint(0, 2 ** 31 - 1, (2, 8, 64, 40), dtype=torch.int32)
    planes = words.to(cuda)
    run, sharding = distributed.make_ensemble_run(
        None, 19, variant="fhp3", p_force=0.05, steps_per_launch=4,
        moments_every=4)
    assert sharding is None
    ops.LAUNCHES = 0
    out, mom = run(planes, 3)
    assert ops.LAUNCHES == 5          # 4 launches of 4 steps + 1 of 3
    want, wmom = run(words, 3)        # plain version on the CPU
    assert torch.equal(out.cpu(), want)
    assert torch.equal(mom.cpu(), wmom)
    assert mom.shape == (2, 4, rulespec.moment_spec(
        rulespec.get_rule("fhp3")).n_moments)



def test_compiled_word_step_is_counted(cuda):
    # The probes compile to straight-line code (counts raises otherwise).
    c = opcount.counts(prng.quantize_p(0.03))
    assert c["step"]["alu"] > 50 and c["step"]["fma"] > 0
    assert c["terms"]["popc"] == len(rulespec.moment_spec(
        rulespec.get_rule("fhp2")).terms)
