"""The plain references of the benchmark, one module per form of the
burst pipeline, in plain torch and independent of the program (none
imports anything of ``hmsr_tpu_torch``). A configuration names its module
(``benchmark.run.load_reference``): ``pipeline``, the fused form at an
integer scale, by default; ``scan``, the scan form at any scale."""
