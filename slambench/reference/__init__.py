"""The plain reference of the benchmark's output check: plain PyTorch,
float32 where the port is float32 (matmuls at full float32, TF32 off), the
pose graph in float64. It imports nothing of ``lidar_slam_tpu_torch`` and
takes nothing the port made: it works the voxelized clouds, normals,
odometry, loop detection, pose graph and occupancy grid out again from the
raw scans, through the same published semantics (the configuration's
``SlamConfig``) written plainly.

Every matmul goes through :class:`Precision`, so the same code run with
``Precision(tf32=True)`` is the control: the reference in TF32, the next
precision below the configuration's (float32 with TF32 off)."""
