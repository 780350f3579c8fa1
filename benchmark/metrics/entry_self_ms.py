"""Host ms per burst inside the user's entry, ``process_arrays``, outside the
pipeline it runs: the copies to the card, the noise model and SNR, the
finishing and the orientation, as the host spends them."""

SPANS = [{"module": "hmsr_tpu_torch.models.process", "name": "process_arrays",
          "span": "process_arrays"},
         {"module": "hmsr_tpu_torch.models.process", "name": "make_pipeline",
          "span": "pipeline", "wrap": "result"}]


def read(view):
    entry, pipe = view.host_ms("process_arrays"), view.host_ms("pipeline")
    if entry is None or pipe is None:
        return None
    return entry - pipe
