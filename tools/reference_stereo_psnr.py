#!/usr/bin/env python3
"""lif_tpu's stereo fidelity on chip_smoke.py's stereo LIF, for the values
it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_stereo_psnr.py``. It authors
chip_smoke.py's main-path-9 LIF (chip_smoke.make_stereo_lif, seed 0: the
port renders the right eye on the CPU), prints its sha256, loads it with
lif_tpu.load_lif_file and prints, for each checked (batch, pose) of that
phase, lif_tpu's render_stereo_fast_batch over the whole batch against
lif_tpu's own 640-step render_stereo_view at that pose, in dB (the
figures chip_smoke.py's LIF_TPU_STEREO_PSNR holds), with the tiers each
eye took (read from the statics lif_tpu's stereo core is compiled for).
About a minute on 8 CPU cores. This is a reference-side tool: it imports
jax and lif_tpu, and the port does not import it.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.models import renderer

    t0 = time.perf_counter()
    data = cs.make_stereo_lif(0)
    print(f"authored in {time.perf_counter() - t0:.1f} s; sha256 "
          f"{hashlib.sha256(data).hexdigest()}", flush=True)
    left, right = lif_tpu.load_lif_file(data).projectors[:2]
    cams = cs.stereo_cams(lif_tpu, float(left.focal[0]),
                          float(left.baseline) / 2.0)
    seen = {}
    real = renderer._stereo_fast_core_jit

    def spy(**statics):
        seen["tiers"] = (tuple(statics["modes_l"]), tuple(statics["modes_r"]))
        return real(**statics)

    renderer._stereo_fast_core_jit = spy
    for name in cs.STEREO_TIERS:
        if name == "pairs":
            continue
        t0 = time.perf_counter()
        fast = np.asarray(lif_tpu.render_stereo_fast_batch(left, right,
                                                           cams[name]))
        for (batch, pose) in cs.LIF_TPU_STEREO_PSNR:
            if batch != name:
                continue
            exact = np.asarray(lif_tpu.render_stereo_view(
                left, right, cams[name][pose], num_steps=640))
            print(f"{name} pose {pose}: {cs.psnr(fast[pose], exact):.3f} dB, "
                  f"tiers {seen['tiers']} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
