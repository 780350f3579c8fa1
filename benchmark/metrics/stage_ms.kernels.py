"""Device ms per burst of the merge kernels' covariance estimation, every
frame and the reference frame."""

NAMES = ("estimate_kernels",)
SPANS = [{"module": "hmsr_tpu_torch.models.pipeline", "name": n, "span": n} for n in NAMES]


def read(view):
    return view.device_ms(NAMES)
