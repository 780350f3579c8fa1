"""Host ms per burst until the pipeline call returns, before anything waits
for the card: where it is close to the burst's wall time, the host's
launches set the pace."""

SPANS = [{"module": "hmsr_tpu_torch.models.process", "name": "make_pipeline",
          "span": "pipeline", "wrap": "result"}]


def read(view):
    return view.host_ms("pipeline")
