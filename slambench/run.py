#!/usr/bin/env python3
"""The benchmark of ``lidar_slam_tpu_torch``, the PyTorch and CUDA port:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``slambench/harness.py``."""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slambench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
