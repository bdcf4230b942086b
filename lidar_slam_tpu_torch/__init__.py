"""PyTorch + CUDA port of the LiDAR SLAM engine, for an NVIDIA H100.

A second package beside the JAX reference ``lidar_slam_tpu``, with the same
layout (``ops/``, ``models/``, ``utils/``, ``config.py``, ``types.py``). It
imports ``torch`` and never ``jax``. The two Pallas kernels of the JAX
package are CUDA C++ kernels here (``csrc/knn.cu``, bound in
``ops/knn_cuda.py``).
"""

__version__ = "0.1.0"
