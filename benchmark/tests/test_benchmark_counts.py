"""The merge's roofline counts and the card's peaks against numbers worked
by hand."""

import pytest

from benchmark.counts.merge import frame_flops, merge_work, ref_flops
from benchmark.peaks import FP32_FLOPS, HBM_BYTES_PER_S, least_seconds


def test_per_pixel_operations():
    assert frame_flops() == 9 * 13 + 25 == 142
    assert ref_flops(1, False) == 142
    assert ref_flops(2, True) == 25 * 14 + 25 == 375


def test_merge_work_small_shape():
    # 3 frames of 4x6 at x2 with 2-px tiles: 2 compared frames, 96 output pixels,
    # a 2x3 tile grid and a 2x3 covariance grid
    nbytes, flops = merge_work(3, 4, 6, 2, 2)
    inputs = 4 * (3 * 24 + 2 * 24 + 2 * 6 * 2 + 3 * 18)
    assert nbytes == inputs + 4 * 3 * 96
    assert flops == 96 * (2 * 142 + 142) + 3 * 96


def test_merge_work_with_denoiser_reads_acc_rob():
    plain = merge_work(3, 4, 6, 3, 2)
    den = merge_work(3, 4, 6, 3, 2, rad_max=2, denoise=True)
    assert den[0] - plain[0] == 4 * 24
    assert den[1] - plain[1] == 216 * (375 - 142)


def test_main_cell_bound():
    # 20 frames of 3000x4000 at x2: 136.5 GFLOP against 3.2 GB, bound by operations
    nbytes, flops = merge_work(20, 3000, 4000, 2, 16)
    assert flops == 48_000_000 * 2840 + 144_000_000
    assert least_seconds(nbytes, flops) == pytest.approx(flops / 67e12)
    assert least_seconds(nbytes, flops) * 1e3 == pytest.approx(2.0368, abs=1e-4)


def test_least_seconds_takes_the_larger():
    assert least_seconds(HBM_BYTES_PER_S, 0) == 1.0
    assert least_seconds(0, FP32_FLOPS) == 1.0
    assert least_seconds(HBM_BYTES_PER_S, 2 * FP32_FLOPS) == 2.0


@pytest.mark.parametrize("scale, rad, den", [(2, 1, False), (3, 2, True)])
def test_merge_work_at_integer_scales_reads_as_before(scale, rad, den):
    # the roofline reader passes the scale as a float: the integer cells'
    # counts stay the integers they were
    as_int = merge_work(20, 3000, 4000, scale, 16, rad, den)
    assert merge_work(20, 3000, 4000, float(scale), 16, rad, den) == as_int
    out_px = scale * 3000 * scale * 4000
    assert as_int[1] == out_px * (19 * 142 + ref_flops(rad if den else 1, den)) + 3 * out_px


def test_merge_work_at_a_fractional_scale():
    # 3 frames of 4x6 at x1.5: a 6x9 image, 54 output pixels; the inputs as at x2
    nbytes, flops = merge_work(3, 4, 6, 1.5, 2)
    inputs = 4 * (3 * 24 + 2 * 24 + 2 * 6 * 2 + 3 * 18)
    assert nbytes == inputs + 4 * 3 * 54
    assert flops == 54 * (2 * 142 + 142) + 3 * 54
    # 5x7 at x1.5: the program's accumulators round half to even, 8 x 10
    assert merge_work(3, 5, 7, 1.5, 2)[1] == 80 * 3 * 142 + 3 * 80


def test_x1_5_cell_bound():
    # 20 frames of 3000x4000 at x1.5: a 4500x6000 image, 76.8 GFLOP
    nbytes, flops = merge_work(20, 3000, 4000, 1.5, 16)
    assert flops == 27_000_000 * 2840 + 81_000_000
    assert least_seconds(nbytes, flops) * 1e3 == pytest.approx(1.1457, abs=1e-4)
