"""The JAX package's accuracy record through its scan pipeline.

Runs ``tools/score_accuracy.py`` (truth and robustness-value sections, the
oracle section skipped) with every configuration's ``tpu.pipeline`` set to
``scan``, the pipeline that ``hmsr_tpu_torch`` follows, and writes the
result with its origin to ``ACCURACY_JAX_SCAN.json`` at the root of the
checkout. ``ACCURACY_r05.json`` came from the same tool with the JAX
package's CPU default, the ``fused`` slab pipeline, whose per-slab refill
also fills interior pixels that no compared frame reached.

Run from the root of a checkout, on the CPU::

    JAX_PLATFORMS=cpu python3 tests/score_jax_scan.py
"""

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ACCURACY_JAX_SCAN.json")


def main():
    spec = importlib.util.spec_from_file_location(
        "jax_score_accuracy", os.path.join(ROOT, "tools", "score_accuracy.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    build_config = tool.build_config

    def scan_config(*args, **kwargs):
        c = build_config(*args, **kwargs)
        c.tpu.pipeline = "scan"
        return c

    tool.build_config = scan_config
    sys.argv = [spec.origin, "--skip-oracle", "--out", OUT]
    tool.main()
    with open(OUT) as f:
        record = json.load(f)
    record["origin"] = ("tools/score_accuracy.py --skip-oracle on the CPU with "
                        "tpu.pipeline=scan, run by tests/score_jax_scan.py")
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
