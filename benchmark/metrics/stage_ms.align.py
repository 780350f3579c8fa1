"""Device ms per burst of the alignment (the grey image, the pyramid, block
matching and the Gauss-Newton steps; K1-K3): every device operation whose
launch lies in the reference's alignment init, a grey conversion or a
frame's alignment."""

NAMES = ("init_alignment", "compute_grey_image", "align")
SPANS = [{"module": "hmsr_tpu_torch.models.pipeline", "name": n, "span": n} for n in NAMES]


def read(view):
    return view.device_ms(NAMES)
