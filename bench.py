#!/usr/bin/env python
"""Benchmark entry point: prints ONE JSON line.

Metric: camera paths/s on the Cornell box (walls + area light + metal/glass
spheres + two cube meshes) at 512x512, spp=128, 10 bounces — the BASELINE.json
headline config. vs_baseline is the ratio to the reference's best published
throughput (512x512 x 32 spp in 3857.46 ms, images/images.MD:44-53). The
result names the device it ran on.
"""

import json
import sys


def main() -> int:
    from rtnw.apps.bench import run_bench
    from rtnw.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    result = run_bench()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
