"""The MLA decode kernel's host side on the CPU: the split plan, the
widths it is compiled for and the work its bound counts (the kernel itself runs on the card only:
``tests/test_torch_gpu.py``)."""
import pytest

from repro_torch.kernels.mla_decode import ops


@pytest.mark.parametrize("rows,heads,t", [(256, 128, 2560), (64, 128, 2560),
                                          (4, 128, 2560), (1, 8, 64),
                                          (3, 4, 2560), (256, 4, 16)])
def test_plan_covers_the_cache_in_whole_key_tiles(rows, heads, t):
    splits, chunk = ops.plan(rows, heads, t, 132)
    assert splits >= 1 and chunk % ops.BLOCK_N == 0
    # Every position lies in exactly one split, and no split is empty.
    assert (splits - 1) * chunk < t <= splits * chunk
    assert splits == 1 or chunk >= ops.MIN_SPLIT_KEYS
    per_split = rows * ops.cdiv(heads, ops.BLOCK_H)
    fill = ops.PROGRAMS_PER_SM * 132
    # Enough programs to fill the card unless the splits reached their
    # floor of keys, and no more splits than filling it takes.
    assert per_split * splits >= fill \
        or splits == ops.cdiv(t, ops.MIN_SPLIT_KEYS)
    assert per_split * (splits - 1) < fill


def test_plan_follows_the_card_and_the_rows():
    # Fewer rows or more multiprocessors: more splits of a row's keys.
    assert ops.plan(4, 128, 2560, 132)[0] > ops.plan(256, 128, 2560, 132)[0]
    assert ops.plan(16, 128, 2560, 264)[0] >= ops.plan(16, 128, 2560, 132)[0]


def test_work_counts_live_keys_only():
    # Rows at positions 0 and 9 of a 16-long cache: 1 + 10 live keys.
    flops, nbytes = ops.work([0, 9], heads=4, c_width=32, r_width=16, t=16)
    assert flops == 11 * 4 * (2 * 48 + 2 * 32)
    assert nbytes == 2 * (11 * 48 + 2 * 4 * (2 * 32 + 16))
    # A position past the cache counts the whole cache.
    assert ops.work([99], 4, 32, 16, 16) == ops.work([15], 4, 32, 16, 16)
    # Whole rows at the cell's widths: ~242 FLOPs a latent byte, under the
    # card's ~295, so the bytes set the bound.
    t = ops.bound_seconds([2559] * 256, 128, 512, 64, 2560)
    keys_bytes = 256 * 2560 * 576 * 2 + 2 * 256 * 128 * (2 * 512 + 64)
    assert t == pytest.approx(keys_bytes / 3.35e12)


@pytest.mark.parametrize("arch", ["deepseek-v3", "deepseek-v3-671b"])
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_every_registered_mla_width_has_a_kernel(arch, smoke):
    from repro_torch.configs import get_config, get_smoke
    m = (get_smoke if smoke else get_config)(arch).mla
    cp, rp = ops.padded_widths(m.kv_lora, m.rope_dim)
    assert (cp, rp) in ops.WIDTHS and m.kv_lora <= cp and m.rope_dim <= rp
    # The published widths take the widest kernel unpadded.
    assert smoke or (cp, rp) == (m.kv_lora, m.rope_dim)


@pytest.mark.parametrize("c_width,r_width", [(12, 8), (32, 4), (520, 64),
                                             (512, 72)])
def test_widths_no_kernel_takes_are_refused(c_width, r_width):
    with pytest.raises(ValueError):
        ops.padded_widths(c_width, r_width)
