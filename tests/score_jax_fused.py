"""The JAX package's accuracy record through its fused pipeline.

Runs ``tools/score_accuracy.py`` (truth and robustness-value sections, the
oracle section skipped) with every configuration's ``tpu.pipeline`` set to
``fused`` (with the default ``tpu.fused_impl: slab``), the form the JAX
package picks on the CPU under ``tpu.pipeline: auto`` and through which
``ACCURACY_r05.json`` was scored. Prints each score beside that record's
and the difference, and writes the result with its origin to ``--out``
(default ``ACCURACY_JAX_FUSED.json`` at the root of the checkout).

Run from the root of a checkout, on the CPU::

    JAX_PLATFORMS=cpu python3 tests/score_jax_fused.py [--out PATH]
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "ACCURACY_r05.json")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "ACCURACY_JAX_FUSED.json"))
    out = ap.parse_args().out
    spec = importlib.util.spec_from_file_location(
        "jax_score_accuracy", os.path.join(ROOT, "tools", "score_accuracy.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    build_config = tool.build_config

    def fused_config(*args, **kwargs):
        c = build_config(*args, **kwargs)
        c.tpu.pipeline = "fused"
        return c

    tool.build_config = fused_config
    sys.argv = [spec.origin, "--skip-oracle", "--out", out]
    tool.main()
    with open(out) as f:
        result = json.load(f)
    result["origin"] = ("tools/score_accuracy.py --skip-oracle on the CPU with "
                        "tpu.pipeline=fused, run by tests/score_jax_fused.py")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    with open(RECORD) as f:
        record = json.load(f)
    rows = [("truth psnr_db", result["truth"]["psnr_db"], record["truth"]["psnr_db"])]
    rows += [(key, result["robustness_value"][key], record["robustness_value"][key])
             for key in ("psnr_ghost_on_db", "psnr_global_on_db", "psnr_ghost_off_db",
                         "psnr_global_off_db")]
    for key, got, want in rows:
        print(f"{key}: {got:.3f} dB, {os.path.basename(RECORD)} {want:.3f} dB, "
              f"difference {got - want:+.3f}", flush=True)


if __name__ == "__main__":
    main()
