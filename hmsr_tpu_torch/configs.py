"""Configuration tree of the port: defaults, YAML files and dotted
overrides, SNR-adaptive resolution and validation (twin of
:mod:`hmsr_tpu.configs`).

The defaults are those of the JAX package's ``configs/default.yaml`` without
its ``tpu:`` implementation switches. The pipeline reads the tree by
attribute and ``.get``, so a tree built by :mod:`hmsr_tpu.configs` works as
well. ``load_yaml`` needs ``pyyaml``, imported where it is used: nothing else
of the port reads YAML.
"""

import copy

import numpy as np

DEFAULTS = {
    "scale": 1,
    "mode": "bayer",            # bayer | grey
    "debug": False,
    "verbose": 1,
    "grey_method": "FFT",       # FFT | decimating
    "noise_model": {"alpha": None, "beta": None},
    "block_matching": {"tuning": {
        # defined fine-to-coarse
        "factors": [1, 2, 4, 4],
        "tile_size": "SNR_based",
        "tile_size_factors": [1, 1, 1, 0.5],
        "search_radii": [1, 4, 4, 4],
        "metrics": ["L1", "L2", "L2", "L2"],
        "flow_upscale_mode": "nearest",     # nearest | bilinear | bicubic
    }},
    "ica": {"tuning": {"n_iter": 3, "sigma_blur": 0}},
    "robustness": {"enabled": True, "save_mask": True,
                   "tuning": {"t": 0.12, "s1": 2, "s2": 12, "Mt": 0.8}},
    "merging": {
        "kernel": "steerable",              # steerable | iso
        "selection_law": "linear",          # hard_threshold | linear
        "tuning": {"k_detail": "SNR_based", "k_denoise": "SNR_based",
                   "D_th": "SNR_based", "D_tr": "SNR_based",
                   "k_stretch": 4, "k_shrink": 2},
    },
    "postprocessing": {
        "enabled": True, "do_color_correction": False,
        "do_gamma_correction": True, "do_tonemapping": False,
        "sharpening": {"enabled": True, "amount": 1.5, "radius": 3},
        "do_devignetting": False,
    },
    "accumulated_robustness_denoiser": {
        "median": {"enabled": False, "radius_max": 3, "max_frame_count": 8},
        "gauss": {"enabled": False, "sigma_max": 1.5, "max_frame_count": 8},
        "merge": {"enabled": False, "rad_max": 2, "max_multiplier": 8,
                  "max_frame_count": 2},
    },
}


class ConfigNode(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))


def _wrap(value):
    if isinstance(value, dict) and not isinstance(value, ConfigNode):
        node = ConfigNode()
        for k, v in value.items():
            node[k] = v
        return node
    return value


def load_yaml(path):
    """Load a YAML file into a :class:`ConfigNode`; raises ``ImportError``
    without ``pyyaml``."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a YAML configuration needs the pyyaml "
                          "package (import yaml), which is not installed") from e
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return _wrap(data or {})


def merge(base, override):
    """Deep-merge ``override`` into a copy of ``base`` (override wins)."""
    out = copy.deepcopy(_wrap(base))

    def _merge(dst, src):
        for k, v in src.items():
            if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
                _merge(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    _merge(out, _wrap(override))
    return out


def update(config, dotted_key, value):
    """Set ``config.a.b.c = value`` from the dotted string ``"a.b.c"``,
    creating the intermediate nodes (the CLI's ``key=value`` overrides).
    Returns ``config``."""
    keys = dotted_key.split(".")
    node = config
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = ConfigNode()
        node = node[k]
    node[keys[-1]] = value
    return config


def default_config():
    """A fresh copy of the default configuration tree."""
    return _wrap(copy.deepcopy(DEFAULTS))


def _lerp(x, x_range, y_range):
    (x0, x1), (y0, y1) = x_range, y_range
    t = max(0.0, min(1.0, (x - x0) / (x1 - x0)))
    return y0 + (y1 - y0) * t


def update_snr_config(config, snr):
    """Resolve the ``"SNR_based"`` entries in place: tile size 64 / 32 / 16
    for SNR <= 14 / <= 22 / above, merge constants interpolated over SNR in
    [6, 30]. Returns ``config``."""
    snr = float(np.clip(snr, 6, 30))
    bm = config.block_matching.tuning
    if bm.tile_size == "SNR_based":
        bm.tile_size = 64 if snr <= 14 else (32 if snr <= 22 else 16)
    if not isinstance(bm.tile_size, int):
        raise ValueError(f"tile_size should be an integer or 'SNR_based', "
                         f"got {bm.tile_size!r}")
    bm.tile_sizes = [int(bm.tile_size * s) for s in bm.tile_size_factors]
    mt = config.merging.tuning
    for key, ends in (("k_detail", (0.33, 0.25)), ("k_denoise", (5.0, 3.0)),
                      ("D_th", (0.81, 0.71)), ("D_tr", (1.24, 1))):
        if mt[key] == "SNR_based":
            mt[key] = _lerp(snr, (6, 30), ends)
        elif not isinstance(mt[key], float):
            raise ValueError(f"{key} should be a float or 'SNR_based', got {mt[key]!r}")
    return config


def sanitize_config(config, imshape):
    """Validate the tree against the raw image shape; raises ``ValueError``
    (or ``NotImplementedError`` for grey mode without the FFT grey) on the
    configurations the JAX package refuses. Returns ``config``."""
    if config.mode == "grey" and config.grey_method != "FFT":
        raise NotImplementedError("Grey level images should be obtained with FFT")
    ard = config.accumulated_robustness_denoiser
    n_ard = sum(1 for x in (ard.median, ard.gauss, ard.merge) if x.enabled)
    bm = config.block_matching.tuning
    correlation = (config.get("tpu") or {}).get("correlation", "direct")
    checks = [
        (config.scale >= 1, f"scale {config.scale} < 1"),
        (config.robustness.enabled or not n_ard,
         "Accumulated robustness denoiser cannot be enabled if robustness is disabled."),
        (config.robustness.enabled or not config.robustness.save_mask,
         "Robustness mask cannot be saved if robustness is disabled."),
        (config.merging.kernel in ("steerable", "iso"),
         f"Unknown kernel type {config.merging.kernel}"),
        (config.mode in ("bayer", "grey"), f"Unknown mode {config.mode}"),
        (n_ard <= 1, "Only one accumulated robustness denoiser can be enabled at a time."),
        (config.ica.tuning.n_iter > 0, "Number of ICA iterations should be positive."),
        (config.ica.tuning.sigma_blur >= 0, f"Invalid sigma blur {config.ica.tuning.sigma_blur}."),
        (len(imshape) == 2, f"Input image shape should be 2D, got {imshape}."),
        (bm.flow_upscale_mode in ("nearest", "bilinear", "bicubic"),
         f"Unknown flow upscaling mode {bm.flow_upscale_mode}."),
        # the JAX package's L2 correlation backends; both give K1's
        # displacements (its FFT correlation equals the direct one)
        (correlation in ("direct", "fft"),
         f"Unknown tpu.correlation {correlation!r}, should be 'direct' or 'fft'."),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)

    # every pyramid level must hold a tile; the alignment runs on the grey
    # image, half-resolution with the decimating grey in bayer mode
    Ts = bm.tile_size
    grey = imshape
    if config.mode == "bayer" and config.get("grey_method", "FFT") == "decimating":
        grey = (imshape[0] // 2, imshape[1] // 2)
    lvl_y, lvl_x = Ts * int(np.ceil(grey[0] / Ts)), Ts * int(np.ceil(grey[1] / Ts))
    for lvl, (factor, ts) in enumerate(zip(bm.factors, bm.tile_sizes)):
        lvl_y, lvl_x = np.floor(lvl_y / factor), np.floor(lvl_x / factor)
        if lvl_y / ts < 1 or lvl_x / ts < 1:
            raise ValueError(
                f"Image of shape {imshape} is incompatible with the block matching "
                f"tile sizes and factors: at level {lvl}, coarse image of shape "
                f"{(lvl_y, lvl_x)} cannot be divided into tiles of size {ts}.")
    return config
