"""K7's refill and divide on the CPU: what its design rests on.

- ``cuda_merge.refill_image`` (K7's image layout: the scan, chunked,
  vmapped and sharded forms' border-strip refill) on CPU tensors, on
  contiguous and on strided planes, agrees with the JAX package's
  ``hmsr_tpu.ops.accumfix.normalize_accum(refill_border=32)`` within
  :data:`TOL` (non-finite values where it has them), and its argument
  checks raise.
- ``accumfix.normalize_border_whole`` (the whole-image refill kept within B
  of an edge, the guarded divide elsewhere: how the kernel computes the
  strips) equals ``normalize_accum(refill_border=B)`` bit for bit, with
  starved pixels on both sides of the 32-px edge and of the 8-px margin,
  at corners and in the interior, on images above and below ``2 (B + 8)``.
- The fast path's premise: at every pixel whose ``den`` is above
  ``STARVED_DEN``, every normalization (per slab, per tile, border strips,
  whole image) is the guarded divide ``num / clamp(den, EPSILON_DIV)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_port_helpers import kernel_counts, max_abs, t  # noqa: E402

from hmsr_tpu.ops import accumfix as j_accumfix  # noqa: E402

from hmsr_tpu_torch.models.pipeline import normalize_image  # noqa: E402
from hmsr_tpu_torch.ops import accumfix, cuda_merge  # noqa: E402
from hmsr_tpu_torch.utils.types import EPSILON_DIV  # noqa: E402

#: depths from the nearest edge at which the tests starve pixels: the
#: border's last rows (31), the interior's first (32-35, inside the 4-px
#: reach of a border pixel's two box passes), the strips' margin (36-39)
#: and past it (40, 41)
DEPTHS = (0, 3, 31, 32, 35, 36, 39, 40, 41)
#: max|d| against the JAX package, as ``tests/test_torch_ops.py`` holds
#: ``normalize_accum``
TOL = 1e-5


def same(a, b):
    """Equal bit for bit as values, NaN where the other is NaN."""
    return a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def accumulators(seed, shape, depths=DEPTHS, interior=0.01, nan=True):
    """num/den of a merge's kind: den in (0.5, 20), 3x3 blocks starved (0 or
    5e-5) at each depth in ``depths`` along every edge and at the corners,
    a share ``interior`` of all pixels starved anywhere, a few NaN dens."""
    rng = np.random.RandomState(seed)
    c, h, w = shape
    den = rng.uniform(0.5, 20.0, shape).astype(np.float32)
    for depth in depths:
        for ch in range(c):
            for y, x in ((depth, rng.randint(w)), (h - 1 - depth, rng.randint(w)),
                         (rng.randint(h), depth), (rng.randint(h), w - 1 - depth),
                         (depth, depth), (h - 1 - depth, w - 1 - depth)):
                y0, x0 = min(max(y - 1, 0), h - 3), min(max(x - 1, 0), w - 3)
                den[ch, y0:y0 + 3, x0:x0 + 3] = rng.choice([0.0, 5e-5])
    den[rng.rand(*shape) < interior] = 0.0
    if nan:
        den[rng.rand(*shape) < 0.002] = np.nan
    num = (np.nan_to_num(den) * rng.rand(*shape)).astype(np.float32)
    return t(num), t(den)


#: (c, h, w): above 2M = 80 on both sides (the strips), then at or under it
#: on one side (the refill everywhere), a width no multiple of 4
SHAPES = [(3, 120, 136), (1, 97, 83), (2, 80, 160), (3, 150, 64), (3, 60, 75)]


def jax_border_refill(num, den, border=accumfix.REFILL_BORDER):
    """The JAX package's ``normalize_accum(refill_border=border)``."""
    return j_accumfix.normalize_accum(jnp.asarray(num.numpy()), jnp.asarray(den.numpy()),
                                      refill_border=border)


@pytest.mark.parametrize("shape", SHAPES)
def test_refill_image_cpu_is_normalize_accum(shape):
    num, den = accumulators(1, shape)
    got = cuda_merge.refill_image(num, den, accumfix.REFILL_BORDER)
    assert max_abs(got, jax_border_refill(num, den)) <= TOL
    assert kernel_counts() == (0,) * 8


def test_refill_image_strided_planes():
    """The sharded pipeline's planes (every other plane of a taller buffer,
    cropped rows) against the JAX package on the same planes, through the
    wrapper and through ``normalize_image``."""
    num, den = accumulators(2, (3, 100, 120))
    full = torch.zeros((6, 112, 120))
    full[:3, :100], full[3:, :100] = num, den
    view = full[:, :100]
    assert not view[:3].is_contiguous()
    want = jax_border_refill(num, den)
    assert max_abs(cuda_merge.refill_image(view[:3], view[3:], 32), want) <= TOL
    assert max_abs(normalize_image(view[:3], view[3:]).permute(2, 0, 1), want) <= TOL


@pytest.mark.parametrize("bad", ["border", "shape", "dtype", "ndim"])
def test_refill_image_checks(bad):
    num, den = accumulators(3, (3, 96, 96))
    border = -1 if bad == "border" else 32
    if bad == "shape":
        den = den[:, :-1]
    elif bad == "dtype":
        num = num.double()
    elif bad == "ndim":
        num, den = num[0], den[0]
    with pytest.raises(ValueError):
        cuda_merge.refill_image(num, den, border)


@pytest.mark.parametrize("depth", DEPTHS + ("interior",))
@pytest.mark.parametrize("shape", [(3, 120, 136), (1, 81, 90), (2, 80, 96), (1, 40, 200)])
def test_normalize_border_whole(shape, depth):
    """Starved 3x3 blocks at one depth (or only inside), B = 32, M = 40."""
    depths = () if depth == "interior" else (depth,)
    num, den = accumulators(4, shape, depths=depths, interior=0.02 if not depths else 0,
                            nan=depth in (0, 32))
    B = accumfix.REFILL_BORDER
    got = accumfix.normalize_border_whole(num, den, B)
    want = accumfix.normalize_accum(num, den, refill_border=B)
    assert same(got, want)
    starved = ~(den > accumfix.STARVED_DEN)
    assert bool(starved.any())
    divide = num / torch.clamp(den, min=EPSILON_DIV)
    if accumfix.strip_width(shape, B) is not None and depth != "interior" and depth < B:
        assert not same(got, divide)    # the refill reached the border blocks


@pytest.mark.parametrize("B", [0, 8, 32])
def test_normalize_border_whole_widths(B):
    """Other strip widths, starved pixels everywhere."""
    num, den = accumulators(5, (2, 112, 128), interior=0.05)
    assert same(accumfix.normalize_border_whole(num, den, B),
                accumfix.normalize_accum(num, den, refill_border=B))


#: the normalizations K7 computes: per B-row slab, per (B, B) tile, the
#: border strips, the whole image
MODES = ["slab", "tile", "border", "whole"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [6, 7])
def test_fast_path_premise(mode, seed):
    """Where den > STARVED_DEN the image is the guarded divide, whatever
    the neighbours hold (NaN and 0 dens among them)."""
    rng = np.random.RandomState(seed)
    shape = (3, 96, 128)
    den = rng.uniform(0, 2, shape).astype(np.float32)
    den[rng.rand(*shape) < 0.15] = 0.0
    den[rng.rand(*shape) < 0.05] = 5e-5
    den[rng.rand(*shape) < 0.01] = np.nan
    num = (np.nan_to_num(den) * rng.uniform(-1, 2, shape)).astype(np.float32)
    num, den = t(num), t(den)
    out = {"slab": lambda: accumfix.normalize_groups(num, den, 32),
           "tile": lambda: accumfix.normalize_groups(num, den, 32, tiles=True),
           "border": lambda: accumfix.normalize_accum(num, den, refill_border=32),
           "whole": lambda: accumfix.normalize_accum(num, den)}[mode]()
    fed = den > accumfix.STARVED_DEN
    assert bool(fed.any()) and not bool(fed.all())
    divide = num / torch.clamp(den, min=EPSILON_DIV)
    assert torch.equal(out[fed], divide[fed])


@pytest.mark.parametrize("argv", [[], ["--wrapper"]])
def test_probe_refill_kernel_needs_the_card(monkeypatch, argv):
    """The K7 probe refuses to run without a card in either mode (no CPU
    fallback for a device measurement)."""
    from hmsr_tpu_torch import probe_refill_kernel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        probe_refill_kernel.main(argv)
