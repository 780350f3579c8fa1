"""Device ms per burst of the merge: the burst's accumulation, the
reference frame's, the refill and the divide, in whichever form the
pipeline runs them (K5-K7)."""

NAMES = ("merge_burst_fused", "merge_tiled", "merge", "_merge_burst_chunked",
         "merge_ref_tiled", "refill_image")
SPANS = [{"module": "hmsr_tpu_torch.models.pipeline", "name": n, "span": n} for n in NAMES]


def read(view):
    return view.device_ms(NAMES)
