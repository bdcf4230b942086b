"""The single-scan entry point and the multi-device dry run (the port's
counterpart of the JAX package's ``__graft_entry__.py``).

:func:`dryrun_multichip` runs the full per-scan program over a device mesh:

- lanes (sequences) spread over the ``seq`` axis, one a ``seq`` index, each
  lane's state on its row's device;
- the odometry ICP's correspondence search sharded over ``pts``
  (``make_sharded_nn1``), then the loop tick and a bounded pose-graph chunk;
- the DB-sharded Scan Context retrieval, which must find its own query;
- the flagship: one full step and a loop pass on a dense cloud of
  ``flagship_points`` (131,072 by default) with the target-sharded 1-NN over
  every device of the mesh, as ``examples/sharded_dense_pipeline.py``.

Iteration budgets are minimal: the dry run shows that the sharded program
runs at these shapes, not that it converges (``chip_smoke.py`` [sharded-dense]
and ``tests/test_torch_parallel.py`` check behaviour)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ICPConfig, LoopClosureConfig, PoseGraphConfig, SlamConfig, tiny_config
from ..models import pipeline as pipe
from ..utils.dataset import generate_world, render_scan
from .batched import optimize_chunk
from .mesh import Mesh, make_mesh
from .sharded_detect import sc_topk_sharded
from .sharded_knn import make_sharded_nn1


def _example_scan(rng, cap: int) -> tuple[np.ndarray, int]:
    """A structured synthetic scan (ground + walls) padded to ``cap`` rows,
    with its row count."""
    world = generate_world(0, route_half=8.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [8.0, 0.0, 1.8]
    scan = render_scan(world, pose, rng, max_range=25.0, max_points=cap)
    pts = np.zeros((cap, 3), np.float32)
    n = min(len(scan), cap)
    pts[:n] = scan[:n]
    return pts, n


def entry(device="cuda"):
    """``(fn, example_args)``: the per-scan SLAM step on the tiny
    configuration (device voxelizer -> point-to-plane ICP -> Scan Context
    -> factor insertion -> occupancy update), after frame 0; ``fn(*args)``
    steps frame 1 in place and returns the state."""
    cfg = tiny_config()
    device = torch.device(device)
    rng = np.random.default_rng(0)
    state = pipe.init_state(cfg, device)
    raw0, n0 = _example_scan(rng, cfg.max_raw_points)
    pipe.init_frame(state, cfg, torch.from_numpy(raw0).to(device), n0)
    raw1, n1 = _example_scan(rng, cfg.max_raw_points)
    nn1 = pipe.resolve_nn1(cfg)

    def fn(state, raw, count, frame):
        return pipe.step(state, cfg, raw, count, frame, nn1)

    return fn, (state, torch.from_numpy(raw1).to(device), n1, 1)


def dryrun_multichip(n_devices: int, devices=None,
                     flagship_points: int = 131072) -> dict:
    """Run the full SLAM step over an ``n_devices`` mesh (``devices``: the
    first ``n_devices`` of the given ones, which may repeat, else of every
    CUDA card) and return what it checked: the mesh, the lanes' pose
    counts, the retrieval's top-1 and the flagship's poses."""
    if devices is None:
        devices = make_mesh().devices.reshape(-1).tolist()
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    pts_ax = 1
    while pts_ax * 2 <= n_devices and n_devices % (pts_ax * 2) == 0 and pts_ax < 4:
        pts_ax *= 2
    seq_ax = n_devices // pts_ax
    mesh = make_mesh({"seq": seq_ax, "pts": pts_ax}, devices=devices)

    cfg = tiny_config(
        max_raw_points=1024, max_points=256, lc_cloud_points=128,
        max_frames=16, max_loop_factors=4,
        icp=ICPConfig(max_iterations=4, normal_k=4),
        pg=PoseGraphConfig(max_iterations=3, cg_iterations=10),
    )
    nn1_fn = make_sharded_nn1(mesh, "pts")
    lane_devices = mesh.axis_devices("seq")
    rng = np.random.default_rng(0)

    def batch_scans():
        return [_example_scan(rng, cfg.max_raw_points) for _ in range(seq_ax)]

    states = [pipe.init_state(cfg, dev) for dev in lane_devices]
    for state, dev, (raw, n) in zip(states, lane_devices, batch_scans()):
        pipe.init_frame(state, cfg, torch.from_numpy(raw).to(dev), n)
    for state, dev, (raw, n) in zip(states, lane_devices, batch_scans()):
        pipe.step(state, cfg, torch.from_numpy(raw).to(dev), n, 1, nn1_fn)
        pipe.loop_tick(state, cfg, 1)
        state.pending_optimize = not optimize_chunk(state, cfg)
    n_poses = [s.n_poses for s in states]
    lanes_finite = all(bool(torch.isfinite(s.poses[: s.n_poses]).all())
                       for s in states)

    # DB-sharded Scan Context retrieval over 'pts': a DB entry as the query
    F, R, S = 8 * pts_ax, cfg.sc.num_rings, cfg.sc.num_sectors
    dev0 = lane_devices[0]
    db = torch.from_numpy(rng.uniform(0, 5, (F, R, S)).astype(np.float32)).to(dev0)
    dbn = torch.sqrt(torch.sum(db.reshape(F, -1) ** 2, dim=1))
    _, i_k, _ = sc_topk_sharded(db[3], db, dbn, 4, mesh, axis="pts")
    top1 = int(i_k[0])
    if top1 != 3:
        raise RuntimeError(f"sharded retrieval self-match failed: {i_k.tolist()}")

    flat = Mesh(mesh.devices.reshape(-1), ("p",))
    flagship = _flagship_sharded_step(flat, flagship_points)
    if not lanes_finite:
        raise RuntimeError("dry run: a lane's poses are not finite")
    print(f"dryrun_multichip OK: mesh {mesh.shape}, batch {seq_ax}, n_poses "
          f"{n_poses}, sharded-detect top1 idx {top1}, flagship sharded step "
          f"at {flagship_points} pts OK", flush=True)
    return dict(mesh=mesh.shape, batch=seq_ax, n_poses=n_poses, top1=top1,
                flagship_points=flagship_points, flagship_poses=flagship)


def _flagship_sharded_step(flat: Mesh, n_points: int) -> np.ndarray:
    """One full SLAM step and loop pass at ``n_points`` with the
    target-sharded 1-NN over the flat mesh ``flat``; returns the first two
    poses, which must be finite."""
    N = n_points
    cfg = SlamConfig(
        max_raw_points=N, max_points=N,
        lc_cloud_points=16384,      # the verification DB's subsample
        max_frames=8, host_voxelize=True, min_points=1024,
        loop_check_every=2, loop_start_frame=1,
        # minimal budgets: one pass each of the sharded program
        icp=ICPConfig(max_iterations=2, tolerance=1e-4, sample_points=2048,
                      warm_start=True),
        lc=LoopClosureConfig(frame_gap=1, verify_sample=1024,
                             icp_max_iterations=2),
        normal_window=8192,          # dense clouds need a wider window
        normal_stride=16,
        pg=PoseGraphConfig(max_iterations=2, cg_iterations=8),
    )
    nn1_fn = make_sharded_nn1(flat, "p")
    dev = flat.devices.flat[0]
    rng = np.random.default_rng(1)
    world = generate_world(0, route_half=20.0, ground_step=0.12)

    def scan(x):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [x, 0.0, 1.8]
        s = render_scan(world, pose, rng, max_range=45.0, max_points=N)
        s = s[np.argsort(s[:, 0], kind="stable")]  # the x-major prep contract
        buf = np.zeros((N, 3), np.float32)
        n = min(len(s), N)
        buf[:n] = s[:n]
        return torch.from_numpy(buf).to(dev), n

    state = pipe.init_state(cfg, dev)
    pipe.init_frame(state, cfg, *scan(0.0))
    pipe.step(state, cfg, *scan(0.4), 1, nn1_fn)
    pipe.loop_tick(state, cfg, 1)
    poses = state.poses[:2].cpu().numpy().copy()
    if not np.isfinite(poses).all():
        raise RuntimeError("flagship sharded step: non-finite poses")
    return poses
