"""Synthetic LiDAR worlds, scans and datasets (jax-free copy of the parts of
``lidar_slam_tpu/utils/dataset.py`` the port's main path and command line
use, the ring-pattern raycast simulator included).

A deterministic "city block" world (ground plane + building walls + poles),
a closed circular route whose last eighth re-drives the start (a true
revisit, so loop closure is observable), and a scan renderer. The code is
copied unchanged so the same seed renders bit-identical scans; the JAX
package's module cannot be imported on a host without JAX (importing
anything under ``lidar_slam_tpu`` imports ``jax``).
``tests/test_torch_imports.py`` holds the two equal.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .io import save_ply


def generate_world(
    seed: int = 0,
    route_half: float = 25.0,
    n_buildings: int | None = None,
    ground_step: float = 0.35,
    corridor: float | None = None,
) -> np.ndarray:
    """Static world point cloud: ground + axis-aligned building walls + poles.

    Buildings are kept off an 8 m-wide corridor around the square route at
    ``|max(|x|,|y|)| = route_half`` so the vehicle never drives through one.

    ``corridor``: if set, only generate the world within this distance of the
    circular route annulus at radius ``route_half`` — a KITTI-length route
    (750 m radius) would otherwise need ~100M ground points at full density;
    a sensor with 50 m range never sees beyond the corridor anyway. Ground
    density stays at ``ground_step`` (no cap) inside the corridor.
    """
    rng = np.random.default_rng(seed)
    extent = route_half * 2.2 + 15.0
    if n_buildings is None:
        # scale structure density with area — a sparse world is perceptually
        # self-similar and produces false Scan Context matches
        area = (
            extent * extent
            if corridor is None
            else 2.0 * np.pi * route_half * (2.0 * corridor)
        )
        n_buildings = max(24, int(area / 450.0))
    pts = []

    def in_corridor(x, y):
        if corridor is None:
            return np.ones(np.shape(x), bool)
        return np.abs(np.hypot(x, y) - route_half) < corridor

    # ground plane with mild height noise; without a corridor, cap total
    # ground points so large worlds stay fast to render (still ~2 points per
    # 0.5 m voxel near the sensor at the cap)
    if corridor is None:
        ground_step = max(ground_step, 2.0 * extent / 1100.0)
        g = np.arange(-extent, extent, ground_step)
        gx, gy = np.meshgrid(g, g)
        gx, gy = gx.ravel(), gy.ravel()
    else:
        # polar grid over the annulus at uniform areal density
        radii = np.arange(
            max(route_half - corridor, 1.0), route_half + corridor, ground_step
        )
        gx_parts, gy_parts = [], []
        for r in radii:
            na = max(int(2.0 * np.pi * r / ground_step), 8)
            ang = np.linspace(0, 2 * np.pi, na, endpoint=False)
            ang += rng.uniform(0, 2 * np.pi / na)  # de-align rings
            gx_parts.append(r * np.cos(ang))
            gy_parts.append(r * np.sin(ang))
        gx = np.concatenate(gx_parts)
        gy = np.concatenate(gy_parts)
    ground = np.stack([gx, gy, rng.normal(0, 0.02, gx.size)], axis=1)
    pts.append(ground)

    # buildings: boxes with 4 wall faces, placed away from the circular route
    for _ in range(n_buildings):
        if corridor is None:
            cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        else:
            ang = rng.uniform(0, 2 * np.pi)
            off = rng.uniform(9.0, corridor)  # roadway (±7 m + margin) clear
            r = route_half + off * (1 if rng.uniform() < 0.5 else -1)
            cx, cy = r * np.cos(ang), r * np.sin(ang)
        # keep the route corridor (annulus around radius route_half) clear
        ring = float(np.hypot(cx, cy))
        if route_half - 7 < ring < route_half + 7:
            scale = (route_half + 9) / max(ring, 1e-3)
            if rng.uniform() < 0.5:
                scale = max((route_half - 9), 1.0) / max(ring, 1e-3)
            cx *= scale
            cy *= scale
        # wide size diversity -> distinctive local skylines (anti-aliasing)
        w, d = rng.uniform(3, 18, 2)
        h = rng.uniform(3, 14)
        density = 3.0  # pts / m^2
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            if axis == 0:  # wall at x = cx +/- w/2, spanning y
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

    # poles / trees near the route for mid-range structure
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


def _overlap_for(n_frames: int) -> int:
    return max(n_frames // 8, 4)


def _frames_per_lap(n_frames: int) -> int:
    # at least 30 frames per lap (<= 12 deg yaw/frame — identity-init ICP
    # cannot track sharper); short datasets become an arc, not a full loop
    return max(n_frames - _overlap_for(n_frames), 30)


def route_half_for(n_frames: int, step: float = 1.2) -> float:
    """Route radius such that the loop closes within ``n_frames`` at a
    KITTI-like ~1.2 m/frame step."""
    return max(_frames_per_lap(n_frames) * step / (2.0 * np.pi), 6.0)


def generate_trajectory(n_frames: int, half: float | None = None, height: float = 1.8):
    """Closed circular route, yaw following the direction of travel.

    The final ``n/8`` frames re-drive the start of the circle (a true
    revisit, like KITTI seq 00 re-entering the same street) so loop closure
    is observable — Scan Context is yaw-invariant but NOT translation
    invariant, so near-coincident revisit poses are required. Per-frame step
    ~1.2 m and a gentle constant yaw rate (identity-init ICP must track the
    motion, as in the reference; sharp corners would break it).
    """
    if half is None:
        half = route_half_for(n_frames)
    ang = 2.0 * np.pi * np.arange(n_frames) / _frames_per_lap(n_frames)
    xy = np.stack([half * np.cos(ang), half * np.sin(ang)], axis=1)
    yaw = ang + np.pi / 2.0  # tangent direction (counter-clockwise)

    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        poses[i] = np.eye(4)
        poses[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i][:3, 3] = [xy[i, 0], xy[i, 1], height]
    return poses


def render_scan(
    world: np.ndarray,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 50.0,
    max_points: int = 20000,
    noise: float = 0.02,
) -> np.ndarray:
    """Simulate one scan: world points in range, in sensor frame, with noise."""
    R, t = pose[:3, :3], pose[:3, 3]
    local = (world - t) @ R  # R^T (world - t)
    r = np.linalg.norm(local[:, :2], axis=1)
    keep = (r < max_range) & (r > 1.0)
    local = local[keep]
    if len(local) > max_points:
        sel = rng.choice(len(local), max_points, replace=False)
        local = local[sel]
    return (local + rng.normal(0, noise, local.shape)).astype(np.float32)


class ScanRenderer:
    """Cell-indexed wrapper around :func:`render_scan` for long routes.

    ``render_scan`` is O(|world|) per frame; on a KITTI-length route the
    world holds 10M+ points and rendering 4.5k frames would take ~40 min.
    A coarse 2D cell index (one argsort at construction) makes each frame
    O(points within range): candidate cells within ``max_range`` of the
    sensor are concatenated and passed through the same crop/sample/noise
    path, so the output distribution is identical to render_scan's."""

    def __init__(self, world: np.ndarray, cell: float = 25.0):
        self.world = world
        self.cell = float(cell)
        cx = np.floor(world[:, 0] / cell).astype(np.int64)
        cy = np.floor(world[:, 1] / cell).astype(np.int64)
        key = (cx - cx.min()) * (cy.max() - cy.min() + 1) + (cy - cy.min())
        order = np.argsort(key)
        self._sorted = world[order]
        skey = key[order]
        # cell id -> [start, end) into the sorted array
        uniq, starts = np.unique(skey, return_index=True)
        ends = np.append(starts[1:], len(skey))
        self._ranges = dict(zip(uniq.tolist(), zip(starts.tolist(), ends.tolist())))
        self._cx0, self._cy0 = cx.min(), cy.min()
        self._ny = cy.max() - cy.min() + 1

    def near(self, x: float, y: float, max_range: float) -> np.ndarray:
        r = int(np.ceil(max_range / self.cell)) + 1
        cx = int(np.floor(x / self.cell)) - self._cx0
        cy = int(np.floor(y / self.cell)) - self._cy0
        parts = []
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                rng_ = self._ranges.get((cx + dx) * self._ny + (cy + dy))
                if rng_ is not None:
                    parts.append(self._sorted[rng_[0] : rng_[1]])
        if not parts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(parts, axis=0)

    def render(
        self,
        pose: np.ndarray,
        rng: np.random.Generator,
        max_range: float = 50.0,
        max_points: int = 20000,
        noise: float = 0.02,
    ) -> np.ndarray:
        sub = self.near(pose[0, 3], pose[1, 3], max_range)
        return render_scan(sub, pose, rng, max_range, max_points, noise)


def make_dataset(
    out_dir: str,
    n_frames: int = 120,
    seed: int = 0,
    max_points: int = 20000,
    fmt: str = "ply",
) -> Tuple[str, np.ndarray]:
    """Write a synthetic dataset: frames as 00000N.ply/.bin + poses_gt.txt
    (KITTI 12-number rows). Returns (out_dir, gt_poses)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    half = route_half_for(n_frames)
    world = generate_world(seed, route_half=half)
    poses = generate_trajectory(n_frames, half=half)
    for i in range(n_frames):
        scan = render_scan(world, poses[i], rng, max_points=max_points)
        if fmt == "bin":
            data = np.concatenate(
                [scan, np.zeros((len(scan), 1), np.float32)], axis=1
            )
            data.tofile(os.path.join(out_dir, f"{i:06d}.bin"))
        else:
            save_ply(os.path.join(out_dir, f"{i:06d}.ply"), scan)
    save_poses_kitti(os.path.join(out_dir, "poses_gt.txt"), poses)
    return out_dir, poses


# ---------------------------------------------------------------------------
# Ring-pattern (rotating multi-beam) LiDAR simulator
#
# The uniform-world `render_scan` above samples visible WORLD points — its
# scan statistics (no ring structure, no occlusion shadows, near-constant
# density) are much friendlier than a real Velodyne HDL-64. The raycast
# renderer below reproduces the geometry a rotating 64-beam sensor actually
# measures: azimuth x elevation ray grid, nearest-surface intersection
# (occlusion), 1/r^2 density falloff, per-return range noise and dropout.
# The closest reproducible stand-in for KITTI seq 00 / an Ouster OS1-64
# recording, on which the reference validates and which cannot be shipped.
# The code is the JAX package's, unchanged: the same seed gives the same
# bytes (the dropout draw before the range-noise draw, every float32 cast).
# ---------------------------------------------------------------------------


class WorldGeom:
    """Analytic world: ground plane + AABB buildings + vertical cylinders."""

    def __init__(self, boxes: np.ndarray, cylinders: np.ndarray,
                 ground_z: float = 0.0):
        self.boxes = boxes.astype(np.float32)        # (B, 6) xmin ymin xmax ymax zmin zmax
        self.cylinders = cylinders.astype(np.float32)  # (C, 4) px py radius height
        self.ground_z = float(ground_z)


def generate_world_geom(
    seed: int = 0, route_half: float = 25.0
) -> WorldGeom:
    """Analytic version of :func:`generate_world`: same layout rules
    (buildings kept off the route corridor, size diversity for distinctive
    skylines), but as surfaces for raycasting instead of sampled points."""
    rng = np.random.default_rng(seed)
    extent = route_half * 2.2 + 15.0
    n_buildings = max(24, int(extent * extent / 450.0))

    boxes = []
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        ring = float(np.hypot(cx, cy))
        if route_half - 7 < ring < route_half + 7:
            scale = (route_half + 9) / max(ring, 1e-3)
            if rng.uniform() < 0.5:
                scale = max((route_half - 9), 1.0) / max(ring, 1e-3)
            cx *= scale
            cy *= scale
        w, d = rng.uniform(3, 18, 2)
        h = rng.uniform(3, 14)
        boxes.append([cx - w / 2, cy - d / 2, cx + w / 2, cy + d / 2, 0.0, h])

    cyls = []
    for _ in range(max(60, int(extent))):
        px, py = rng.uniform(-extent, extent, 2)
        ring = float(np.hypot(px, py))
        if abs(ring - route_half) < 2.5:  # not on the roadway itself
            px *= (route_half + 4) / max(ring, 1e-3)
            py *= (route_half + 4) / max(ring, 1e-3)
        cyls.append([px, py, 0.2, rng.uniform(2.5, 5.0)])

    return WorldGeom(np.asarray(boxes), np.asarray(cyls))


def _ray_dirs(n_beams: int, n_azimuth: int, vfov_deg) -> np.ndarray:
    """(n_beams * n_azimuth, 3) unit directions, sensor frame (x fwd, z up)."""
    el = np.deg2rad(np.linspace(vfov_deg[0], vfov_deg[1], n_beams))
    az = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(el), np.sin(el)
    ca, sa = np.cos(az), np.sin(az)
    d = np.stack(
        [
            (ce[:, None] * ca[None, :]),
            (ce[:, None] * sa[None, :]),
            np.broadcast_to(se[:, None], (n_beams, n_azimuth)),
        ],
        axis=-1,
    )
    return d.reshape(-1, 3).astype(np.float32)


def render_scan_rings(
    geom: WorldGeom,
    pose: np.ndarray,
    rng: np.random.Generator,
    n_beams: int = 64,
    n_azimuth: int = 1024,
    vfov_deg=(-24.8, 2.0),
    max_range: float = 80.0,
    min_range: float = 1.5,
    noise: float = 0.02,
    dropout: float = 0.02,
) -> np.ndarray:
    """Raycast one rotating-LiDAR scan (HDL-64-like geometry, sensor frame).

    Nearest-hit over ground plane / boxes / cylinders gives real occlusion
    shadows; range noise is applied along the ray (so error grows with the
    lever arm, as on real sensors)."""
    R, t = pose[:3, :3].astype(np.float32), pose[:3, 3].astype(np.float32)
    d_sensor = _ray_dirs(n_beams, n_azimuth, vfov_deg)     # (N, 3)
    d = d_sensor @ R.T                                     # world-frame dirs
    o = t
    N = d.shape[0]
    t_best = np.full(N, np.inf, np.float32)

    # ground plane z = ground_z
    dz = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (geom.ground_z - o[2]) / dz
    hit = (dz < -1e-6) & (tg > 0)
    t_best = np.where(hit, np.minimum(t_best, tg.astype(np.float32)), t_best)

    # boxes, pruned to the sensor's range disc
    bx = geom.boxes
    if len(bx):
        cx = (bx[:, 0] + bx[:, 2]) / 2
        cy = (bx[:, 1] + bx[:, 3]) / 2
        diag = np.hypot(bx[:, 2] - bx[:, 0], bx[:, 3] - bx[:, 1]) / 2
        near = np.hypot(cx - o[0], cy - o[1]) - diag < max_range
        for b in bx[near]:
            lo = np.array([b[0], b[1], b[4]], np.float32)
            hi = np.array([b[2], b[3], b[5]], np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo[None, :] - o[None, :]) / d
                t2 = (hi[None, :] - o[None, :]) / d
            tmin = np.nanmax(np.minimum(t1, t2), axis=1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=1)
            ok = (tmax >= tmin) & (tmin > 0)
            t_best = np.where(ok, np.minimum(t_best, tmin), t_best)

    # cylinders (vertical), pruned the same way
    cl = geom.cylinders
    if len(cl):
        near = np.hypot(cl[:, 0] - o[0], cl[:, 1] - o[1]) < max_range + 1
        for c in cl[near]:
            ox, oy = o[0] - c[0], o[1] - c[1]
            a = d[:, 0] ** 2 + d[:, 1] ** 2
            b2 = 2 * (d[:, 0] * ox + d[:, 1] * oy)
            c0 = ox * ox + oy * oy - c[2] * c[2]
            disc = b2 * b2 - 4 * a * c0
            ok = (disc > 0) & (a > 1e-12)
            sq = np.sqrt(np.maximum(disc, 0))
            th = (-b2 - sq) / np.maximum(2 * a, 1e-12)
            zh = o[2] + th * d[:, 2]
            ok &= (th > 0) & (zh >= 0) & (zh <= c[3])
            t_best = np.where(ok, np.minimum(t_best, th), t_best)

    keep = (t_best >= min_range) & (t_best <= max_range)
    if dropout > 0:
        keep &= rng.uniform(size=N) >= dropout
    tr = t_best[keep] + rng.normal(0, noise, keep.sum()).astype(np.float32)
    return (tr[:, None] * d_sensor[keep]).astype(np.float32)


def make_rings_dataset(
    out_dir: str,
    n_frames: int = 1000,
    seed: int = 0,
    n_beams: int = 64,
    n_azimuth: int = 1024,
    fmt: str = "bin",
) -> Tuple[str, np.ndarray]:
    """Write a raycast ring-LiDAR dataset (frames + poses_gt.txt)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    half = route_half_for(n_frames)
    geom = generate_world_geom(seed, route_half=half)
    poses = generate_trajectory(n_frames, half=half)
    for i in range(n_frames):
        scan = render_scan_rings(
            geom, poses[i], rng, n_beams=n_beams, n_azimuth=n_azimuth
        )
        if fmt == "bin":
            data = np.concatenate(
                [scan, np.zeros((len(scan), 1), np.float32)], axis=1
            )
            data.tofile(os.path.join(out_dir, f"{i:06d}.bin"))
        else:
            save_ply(os.path.join(out_dir, f"{i:06d}.ply"), scan)
    np.savetxt(
        os.path.join(out_dir, "poses_gt.txt"),
        poses[:, :3, :].reshape(n_frames, 12),
        fmt="%.6f",
    )
    return out_dir, poses


def save_poses_kitti(path: str, poses: np.ndarray) -> None:
    """Write (n, 4, 4) poses in the KITTI odometry format, 12 numbers (3x4)
    per row: the ground truth of a dataset and an exported trajectory."""
    np.savetxt(path, poses[:, :3, :].reshape(len(poses), 12), fmt="%.6f")


def load_gt_poses(path: str) -> np.ndarray:
    """Read KITTI-format 12-number pose rows -> (n, 4, 4)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = len(rows)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :] = rows
    return poses
