"""``python -m lidar_slam_tpu_torch`` runs the command line."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
