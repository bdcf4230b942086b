"""The one traffic generator of the benchmark: a seeded synthetic drive.

A traffic mix is a JSON file beside this module (``<traffic>.json``) of
parameters that :func:`make_drive` reads:

- ``frames``: scans in one drive;
- ``revisit_share``: the share of the drive that re-drives earlier road.
  The route is a circle of ``lap_frames = frames - floor(frames *
  revisit_share)`` frames a lap, driven on without a stop, so the last
  ``frames - lap_frames`` frames pass where the first lap passed;
- ``laps``: whole laps in the drive, ``frames // lap_frames`` (a check on
  the two numbers above);
- ``step_m``: metres driven a frame (KITTI's ~1.2 m at 10 Hz);
- ``raw_points``: points a scan keeps of those in range;
- ``corridor_m``: the world is generated within this distance of the route;
- ``max_range_m``, ``noise_m``: the sensor's range and range noise;
- ``recording_seed``: the seed of the recorded drive, the world and what
  the sensor returned (which points, their noise). A mix fixes it, as a
  recorded sequence is fixed: whether an ICP converges within its budget
  depends on the noise, so a drive drawn anew for every run does more or
  less work (on ``revisit4x75``, 10-21 odometry frames lost to the budget
  and finalize 0.15-2.4 s, scans/s 22-34 over 6 seeds). The run's
  ``--seed`` orders each scan's points: every run does the same work, and
  each rounds it its own way (sums over a voxel's points in another
  order).

The world (ground, building walls, poles) is a frozen copy of the port's
``utils/dataset.generate_world``, unchanged, so a seed gives the world that
the port's own tools render. Scans are drawn on the device from a
``torch.Generator`` seeded with the recording seed: each is the world
points within range in the sensor frame (1 m < r < ``max_range_m``), a draw
of ``raw_points`` of them without replacement, plus Gaussian noise, the
distribution of the port's ``render_scan``; then a second generator,
seeded with the run's seed, permutes each scan's points. Every drive of a
run replays the same scans.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Traffic:
    name: str
    frames: int
    laps: int
    revisit_share: float
    step_m: float
    raw_points: int
    corridor_m: float
    max_range_m: float
    noise_m: float
    recording_seed: int

    @property
    def lap_frames(self) -> int:
        return self.frames - int(np.floor(self.frames * self.revisit_share))

    @property
    def route_radius_m(self) -> float:
        return max(self.lap_frames * self.step_m / (2.0 * np.pi), 6.0)


def load_traffic(name: str, directory: Path = TRAFFIC_DIR) -> Traffic:
    """The mix ``<directory>/<name>.json``; its laps must agree with its
    frames and revisit share."""
    params = json.loads((Path(directory) / f"{name}.json").read_text())
    params.pop("why", None)
    t = Traffic(name=name, **params)
    if t.lap_frames < 1 or t.frames // t.lap_frames != t.laps:
        raise ValueError(f"traffic {name}: {t.frames} frames at revisit share "
                         f"{t.revisit_share} make {t.frames // max(t.lap_frames, 1)} "
                         f"laps of {t.lap_frames}, not {t.laps}")
    return t


def generate_world(
    seed: int = 0,
    route_half: float = 25.0,
    n_buildings: int | None = None,
    ground_step: float = 0.35,
    corridor: float | None = None,
) -> np.ndarray:
    """Static world point cloud: ground + axis-aligned building walls + poles
    (a copy of ``lidar_slam_tpu_torch/utils/dataset.py:generate_world``)."""
    rng = np.random.default_rng(seed)
    extent = route_half * 2.2 + 15.0
    if n_buildings is None:
        area = (
            extent * extent
            if corridor is None
            else 2.0 * np.pi * route_half * (2.0 * corridor)
        )
        n_buildings = max(24, int(area / 450.0))
    pts = []

    if corridor is None:
        ground_step = max(ground_step, 2.0 * extent / 1100.0)
        g = np.arange(-extent, extent, ground_step)
        gx, gy = np.meshgrid(g, g)
        gx, gy = gx.ravel(), gy.ravel()
    else:
        radii = np.arange(
            max(route_half - corridor, 1.0), route_half + corridor, ground_step
        )
        gx_parts, gy_parts = [], []
        for r in radii:
            na = max(int(2.0 * np.pi * r / ground_step), 8)
            ang = np.linspace(0, 2 * np.pi, na, endpoint=False)
            ang += rng.uniform(0, 2 * np.pi / na)
            gx_parts.append(r * np.cos(ang))
            gy_parts.append(r * np.sin(ang))
        gx = np.concatenate(gx_parts)
        gy = np.concatenate(gy_parts)
    ground = np.stack([gx, gy, rng.normal(0, 0.02, gx.size)], axis=1)
    pts.append(ground)

    for _ in range(n_buildings):
        if corridor is None:
            cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        else:
            ang = rng.uniform(0, 2 * np.pi)
            off = rng.uniform(9.0, corridor)
            r = route_half + off * (1 if rng.uniform() < 0.5 else -1)
            cx, cy = r * np.cos(ang), r * np.sin(ang)
        ring = float(np.hypot(cx, cy))
        if route_half - 7 < ring < route_half + 7:
            scale = (route_half + 9) / max(ring, 1e-3)
            if rng.uniform() < 0.5:
                scale = max((route_half - 9), 1.0) / max(ring, 1e-3)
            cx *= scale
            cy *= scale
        w, d = rng.uniform(3, 18, 2)
        h = rng.uniform(3, 14)
        density = 3.0
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            if axis == 0:
                area = d * h
                n = max(int(area * density), 8)
                y = rng.uniform(cy - d / 2, cy + d / 2, n)
                z = rng.uniform(0, h, n)
                x = np.full(n, cx + sign * w / 2)
            else:
                area = w * h
                n = max(int(area * density), 8)
                x = rng.uniform(cx - w / 2, cx + w / 2, n)
                z = rng.uniform(0, h, n)
                y = np.full(n, cy + sign * d / 2)
            pts.append(np.stack([x, y, z], axis=1))

    for _ in range(max(60, int(extent))):
        if corridor is None:
            px, py = rng.uniform(-extent, extent, 2)
        else:
            ang = rng.uniform(0, 2 * np.pi)
            r = route_half + rng.uniform(-corridor, corridor)
            px, py = r * np.cos(ang), r * np.sin(ang)
        n = 30
        z = rng.uniform(0, 4, n)
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 0.2
        pts.append(
            np.stack([px + r * np.cos(ang), py + r * np.sin(ang), z], axis=1)
        )

    return np.concatenate(pts, axis=0).astype(np.float32)


def route(t: Traffic, height: float = 1.8) -> np.ndarray:
    """(frames, 4, 4) float32 ground-truth poses: counter-clockwise around a
    circle of ``t.lap_frames`` frames a lap, yaw along the direction of
    travel (the port's ``generate_trajectory`` with the lap length free)."""
    ang = 2.0 * np.pi * np.arange(t.frames) / t.lap_frames
    half = t.route_radius_m
    yaw = ang + np.pi / 2.0
    poses = np.zeros((t.frames, 4, 4), np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    poses[:, 2, 2] = 1.0
    poses[:, 3, 3] = 1.0
    poses[:, 0, 3] = half * np.cos(ang)
    poses[:, 1, 3] = half * np.sin(ang)
    poses[:, 2, 3] = height
    return poses


def render(world: torch.Tensor, pose: np.ndarray, gen: torch.Generator,
           t: Traffic) -> torch.Tensor:
    """One scan on ``world``'s device: the points within range in the sensor
    frame, ``t.raw_points`` of them drawn without replacement (in draw
    order), plus N(0, noise) per coordinate. Elementwise arithmetic only,
    so no matmul precision setting touches it."""
    R = torch.from_numpy(np.ascontiguousarray(pose[:3, :3])).to(world.device)
    d = world - torch.from_numpy(pose[:3, 3].copy()).to(world.device)
    # R^T (p - t), written out
    local = torch.stack([d[:, 0] * R[0, k] + d[:, 1] * R[1, k] + d[:, 2] * R[2, k]
                         for k in range(3)], dim=1)
    r = torch.sqrt(local[:, 0] * local[:, 0] + local[:, 1] * local[:, 1])
    idx = torch.nonzero((r < t.max_range_m) & (r > 1.0)).flatten()
    if idx.numel() > t.raw_points:
        sel = torch.randperm(idx.numel(), generator=gen, device=world.device)
        idx = idx[sel[: t.raw_points]]
    pts = local[idx]
    noise = torch.randn(pts.shape, generator=gen, device=world.device,
                        dtype=pts.dtype)
    return pts + noise * t.noise_m


def make_drive(t: Traffic, seed: int, device) -> tuple[list, np.ndarray]:
    """The mix's recorded drive with each scan's points in the order of
    ``seed``: its raw scans as host float32 arrays (the form
    ``SlamEngine.push_scan`` takes) and the ground-truth poses."""
    world_np = generate_world(t.recording_seed, route_half=t.route_radius_m,
                              corridor=t.corridor_m)
    world = torch.from_numpy(world_np).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(t.recording_seed)
    order = torch.Generator(device=device)
    order.manual_seed(int(seed) % (1 << 63))
    gt = route(t)
    scans = []
    for i in range(t.frames):
        s = render(world, gt[i], gen, t)
        scans.append(s[torch.randperm(s.shape[0], generator=order, device=device)])
    host = torch.stack(scans).cpu().numpy() if len({s.shape[0] for s in scans}) == 1 \
        else None
    if host is not None:
        return [host[i] for i in range(t.frames)], gt
    return [s.cpu().numpy() for s in scans], gt
