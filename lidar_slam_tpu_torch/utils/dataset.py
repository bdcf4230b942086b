"""Synthetic LiDAR worlds and scans (jax-free copy of the parts of
``lidar_slam_tpu/utils/dataset.py`` the port's main path uses).

A deterministic "city block" world (ground plane + building walls + poles),
a closed circular route whose last eighth re-drives the start (a true
revisit, so loop closure is observable), and a scan renderer. The code is
copied unchanged so the same seed renders bit-identical scans; the JAX
package's module cannot be imported on a host without JAX (importing
anything under ``lidar_slam_tpu`` imports ``jax``).
``tests/test_torch_imports.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np


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
