"""Regenerate golden images (run deliberately after intentional changes).

    python tests/regen_goldens.py            # every case
    python tests/regen_goldens.py smallpt    # the named cases only
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from rtnw.config import RenderConfig  # noqa: E402
from rtnw.models import integrator  # noqa: E402
from tests.test_goldens import CASES, GOLDEN_DIR  # noqa: E402


def main(names=None) -> None:
    for name, (build, kw) in CASES.items():
        if names and name not in names:
            continue
        scene, camera = build()
        cfg = RenderConfig(**kw)
        img = np.asarray(integrator.render(scene, camera, cfg).mean)
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"{name}.npz"), image=img)
        print(name, img.shape, "mean %.4f" % img.mean())


if __name__ == "__main__":
    main(sys.argv[1:])
