"""Device ms per burst of robustness (guide statistics, the upscale-warp K4,
the noise-corrected distance, the 5x5 minimum): the reference's
statistics and every frame's map."""

NAMES = ("init_robustness", "compute_robustness")
SPANS = [{"module": "hmsr_tpu_torch.models.pipeline", "name": n, "span": n} for n in NAMES]


def read(view):
    return view.device_ms(NAMES)
