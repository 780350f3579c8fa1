"""Shared helpers of the tests that hold ``hmsr_tpu_torch`` (the PyTorch
port) against ``hmsr_tpu`` (the JAX reference).

Inputs are made with numpy from a seed and handed to both; JAX runs on the
CPU through its own non-Pallas twins (``tiled`` merge/ICA/warp), the port on
CPU tensors through the plain versions of its kernels.
"""

import builtins
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # six xdist workers share the host

ALPHA, BETA = 1.8e-4, 3.0e-6
WB = [1.0, 1.0, 1.0]


def curves():
    """Analytic noise curves of the affine model, as numpy float32."""
    b = np.arange(1001) / 1000.0
    std = np.sqrt(np.maximum(ALPHA * b + BETA, 0)).astype(np.float32)
    diff = np.sqrt(2 / np.pi * 2 * (ALPHA * b + BETA) / 9).astype(np.float32)
    return std, diff


def small_config(size=128, ts=16):
    """``__graft_entry__._small_config`` (2 levels) at tile size ``ts``,
    with the JAX reference on its scan pipeline."""
    from __graft_entry__ import _small_config
    c = _small_config(h=size, w=size)
    c.block_matching.tuning.tile_size = ts
    c.block_matching.tuning.tile_sizes = [ts, ts]
    c.tpu.pipeline = "scan"
    return c


def default_config(size, snr=40):
    """The ``bench.py`` configuration (default 4-level tuning, x2; SNR 40
    gives Ts=16), with the JAX reference on its scan pipeline."""
    from hmsr_tpu.configs import default_config as dc, sanitize_config, update_snr_config
    c = dc()
    c.scale = 2
    c.verbose = 0
    c.noise_model.alpha = ALPHA
    c.noise_model.beta = BETA
    c.accumulated_robustness_denoiser.enabled = False
    update_snr_config(c, snr)
    sanitize_config(c, (size, size))
    c.tpu.pipeline = "scan"
    return c


def t(x):
    """numpy / JAX array -> CPU tensor."""
    return torch.as_tensor(np.array(x))


def n(x):
    """tensor / JAX array -> numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def max_abs(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    return float(np.max(np.abs(got[both] - want[both]))) if both.any() else 0.0


def rel_err(got, want):
    """max|got - want| / max|want| over finite entries."""
    return max_abs(got, want) / max(float(np.nanmax(np.abs(n(want)))), 1e-30)


def kernel_counts():
    from hmsr_tpu_torch.ops import cuda_ica, cuda_merge, cuda_warp
    return (cuda_ica.block_match.launches, cuda_ica.ica_steps.launches,
            cuda_ica.ica_fused.launches, cuda_warp.upscale_warp.launches,
            cuda_merge.merge_accumulate.launches,
            cuda_merge.merge_burst_accumulate.launches,
            cuda_merge.merge_fused_accumulate.launches)


def block_imports(monkeypatch, *names):
    """Make ``import`` of the given top-level modules raise ``ImportError``
    for the rest of the test (the card's machine lacks some packages that
    this host has)."""
    real_import = builtins.__import__

    def fake(name, *a, **k):
        if name.split(".")[0] in names:
            raise ImportError(f"{name} made unavailable by the test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake)
    for m in list(sys.modules):
        if m.split(".")[0] in names:
            monkeypatch.delitem(sys.modules, m)
