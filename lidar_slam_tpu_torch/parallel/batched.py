"""Batched multi-sequence SLAM (port of ``lidar_slam_tpu/parallel/batched.py``;
the configuration ladder's rung 4: several sequences at once on one card).

B sequences run in lockstep: frame f of every lane is processed together,
and the state is the port's :class:`~..models.pipeline.SlamState` with a
leading lane dimension (tensors (B, ...), host counters as per-lane lists;
``pipeline.stack_states``). The lanes are a real batch dimension where a
batch costs less than a loop:

- odometry: the B prepared clouds go through ONE point-to-plane ICP of B
  lanes, so each iteration's correspondence search is one launch for every
  lane (K1 in fast mode, K2 in the exact modes); a converged lane stays
  frozen while the others iterate;
- the pose chain, the odometry factors, the occupancy patches ((B, D, D)
  grids, one scatter) and the keyframe-DB write (one write per field, one
  Scan Context scatter) take all lanes at once;
- loop ticks: one Scan Context retrieval per lane, then each verification
  tranche of every lane in ONE batched ICP (3 x B K2 lanes; a lane that
  needs no tranche enters inactive, ``loop_closure.detect_lanes``).

Loops over lanes remain where a batch would not save work: the normals (their
slab sweeps are cut into chunks of 2^26 distance evaluations, so B lanes run
B times the chunks either way), the device voxelizer of raw scans, the
mid-run pose-graph chunk and finalize (one float64 LM per lane, then the
occupancy rebuild, as ``SlamEngine.finalize``).

Semantics follow the JAX batched engine, which differ from the single
engine's in two places (ROADMAP.md, Queue 3): the mid-run optimize is gated
on ``pending_optimize`` (a lane whose chunk did not converge runs again at
every tick) and optimizes the whole graph (no ``window_loops``); with
``optimize_midrun=False`` (``--mode fast``) no chunk runs and the lanes
equal the single engine. As in the JAX batched engine, scans carry no host
normals: the normals are always estimated on the device. Each cadence tick
runs right after its frame; the JAX engine's dispatch blocks, multi-tick
bunching and f32 finalize ladder exist for the TPU and are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..models import loop_closure as lc
from ..models import pipeline as pipe
from ..models import pose_graph as pg
from ..ops import knn_cuda, se3
from ..ops.icp import icp_point_to_plane
from ..ops.occupancy import update_occupancy
from ..ops.voxel import voxel_downsample
from ..types import PointCloud


def init_states(config: SlamConfig, batch: int, device) -> pipe.SlamState:
    """Blank lane-stacked state of ``batch`` lanes."""
    return pipe.stack_states([pipe.init_state(config, device)
                              for _ in range(batch)])


def prep_clouds(config: SlamConfig, raw: torch.Tensor, counts: list) -> PointCloud:
    """(B, cap, 3) padded scans + counts -> the (B, max_points) masked
    clouds, as ``pipeline.prep_cloud`` on each lane."""
    if config.host_voxelize:
        pts = raw[:, : config.max_points]
        cnt = torch.tensor(counts, device=raw.device)
        mask = torch.arange(pts.shape[1], device=raw.device)[None] < cnt[:, None]
        return PointCloud(torch.where(mask[..., None], pts, torch.zeros_like(pts)),
                          mask)
    clouds = [voxel_downsample(r, torch.arange(r.shape[0], device=r.device) < c,
                               config.voxel_size, config.max_points)
              for r, c in zip(raw, counts)]
    return PointCloud(torch.stack([c.points for c in clouds]),
                      torch.stack([c.mask for c in clouds]))


def _normals(config: SlamConfig, curr: PointCloud) -> torch.Tensor:
    est = pipe.normals_fn(config)
    return torch.stack([est(p, m) for p, m in zip(curr.points, curr.mask)])


def _npts(config: SlamConfig, curr: PointCloud, counts: list) -> list:
    """Each lane's prepared count (decides the ``min_points`` skip): the
    host's row count under ``host_voxelize``, else one readback."""
    if config.host_voxelize:
        return [min(c, config.max_points) for c in counts]
    return curr.count().cpu().tolist()


def init_lanes(state: pipe.SlamState, config: SlamConfig, raw: torch.Tensor,
               counts: list) -> None:
    """Frame 0 of every lane (``pipeline.init_frame``), in place."""
    curr = prep_clouds(config, raw, counts)
    normals = _normals(config, curr)
    lc.add_frame_lanes(state.db, curr, 0, config.sc,
                       [False] * len(counts), normals)
    state.prev, state.prev_normals = curr, normals
    state.frame_npts[:, 0] = curr.count().to(torch.int32)


def step_lanes(state: pipe.SlamState, config: SlamConfig, raw: torch.Tensor,
               counts: list, frame: int, nn1_fn) -> None:
    """One odometry step of every lane (``pipeline.step`` over lanes), in
    place."""
    dev = raw.device
    curr = prep_clouds(config, raw, counts)
    npts = _npts(config, curr, counts)
    ok = torch.tensor([n >= config.min_points for n in npts], device=dev)

    init_T = state.prev_delta if config.icp.warm_start else None
    res = icp_point_to_plane(curr, state.prev, state.prev_normals, config.icp,
                             init_T, nn1_fn=nn1_fn)
    fitness = torch.where(torch.isfinite(res.final_error), res.final_error,
                          torch.full_like(res.final_error, 1e6))
    diverged = ~res.converged | (fitness > config.divergence_error)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    delta = torch.where((ok & ~diverged)[:, None, None], res.transformation, eye)

    new_pose = se3.orthonormalize(se3.compose(state.poses[:, frame - 1], delta))
    state.poses[:, frame] = new_pose
    g = state.pg  # pose_graph.add_odometry over lanes
    g.poses[:, frame] = se3.compose(g.poses[:, frame - 1], delta)
    g.n_poses = [max(n, frame + 1) for n in g.n_poses]
    g.odom_rel[:, frame] = delta
    g.odom_valid[:, frame] = ok
    g.odom_scale[:, frame] = 1.0 + fitness * 10.0

    world = se3.apply(new_pose, curr.points)
    state.occ_dropped += update_occupancy(
        state.grid, world, curr.mask & ok[:, None], se3.trans(new_pose)[:, :2],
        config.grid)
    normals = _normals(config, curr)
    lc.add_frame_lanes(state.db, curr, frame, config.sc, ok.cpu().tolist(),
                       normals)

    state.n_poses = [max(n, frame + 1) for n in state.n_poses]
    state.prev, state.prev_normals, state.prev_delta = curr, normals, delta
    state.icp_error[:, frame] = fitness
    state.icp_iters[:, frame] = res.num_iterations
    state.icp_converged[:, frame] = res.converged
    state.frame_npts[:, frame] = torch.tensor(npts, dtype=torch.int32, device=dev)


def gated_optimize(state: pipe.SlamState, config: SlamConfig) -> None:
    """The JAX batched engine's mid-run optimize (``make_gated_optimize``),
    in place: every lane with ``pending_optimize`` set runs one float32 LM
    chunk of ``inline_max_iterations`` over its WHOLE graph, and stays
    pending while the chunk does not converge."""
    for b, pending in enumerate(state.pending_optimize):
        if not pending:
            continue
        lane = pipe.lane_state(state, b)
        res = pg.optimize(lane.pg.replace(poses=lane.poses), config.pg,
                          max_iterations=config.pg.inline_max_iterations)
        lane.poses[: lane.n_poses] = res.poses[: lane.n_poses]
        state.pending_optimize[b] = not res.converged


def loop_tick_lanes(state: pipe.SlamState, config: SlamConfig, frame: int,
                    optimize_midrun: bool) -> list:
    """Loop detection for ``frame`` on every lane and the factors and
    counters it adds (``pipeline.loop_tick`` over lanes); with
    ``optimize_midrun`` the gated chunk follows. Returns the detections."""
    B = len(state.n_poses)
    dets = lc.detect_lanes(state.db, config.lc, config.sc, knn_cuda.nn1,
                           [frame] * B)
    for b, det in enumerate(dets):
        lane = pipe.lane_state(state, b)
        pipe.record_detection(lane, config, det)
        pipe.set_lane(state, b, lane)
    if optimize_midrun and any(state.pending_optimize):
        gated_optimize(state, config)
    return dets


class BatchedSlamEngine:
    """Run ``batch`` sequences in lockstep on one device.

    ``device``: the card by default; without CUDA that raises, and the CPU
    must be asked for (as the tests do). ``optimize_midrun`` as in the JAX
    engine (the command line passes ``config.optimize_midrun``). ``mesh``
    (sharding the lanes over several cards) is not ported."""

    def __init__(self, config: SlamConfig, batch: int, device="cuda",
                 optimize_midrun: bool = True, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "BatchedSlamEngine(mesh=...) is not ported: multi-GPU "
                "sharding is ROADMAP.md Queue 1, item 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedSlamEngine runs on an NVIDIA GPU by default and CUDA "
                "is not available; pass device='cpu' to run on the CPU")
        pipe.pin_f32_matmuls()
        self.config = config
        self.batch = batch
        self._optimize_midrun = optimize_midrun
        self._nn1 = pipe.resolve_nn1(config)
        self._resident: Optional[tuple] = None
        self.state = init_states(config, batch, self.device)
        self._frame = 0

    def reset(self) -> None:
        """Blank the state for another run in this process; preloaded scans
        stay on the device."""
        self.state = init_states(self.config, self.batch, self.device)
        self._frame = 0

    # -- scan feeding ------------------------------------------------------

    @property
    def _scan_cap(self) -> int:
        cfg = self.config
        return cfg.max_points if cfg.host_voxelize else cfg.max_raw_points

    def pad_scans(self, scans) -> tuple[torch.Tensor, list]:
        """One scan per lane, padded to the input capacity (``max_points``
        under ``host_voxelize``, else ``max_raw_points``, as
        ``SlamEngine.pad_scan``) and put on the device; with the counts."""
        if len(scans) != self.batch:
            raise ValueError(f"{len(scans)} scans for {self.batch} lanes")
        cap = self._scan_cap
        out = np.zeros((self.batch, cap, 3), np.float32)
        counts = []
        for b, s in enumerate(scans):
            n = min(len(s), cap)
            out[b, :n] = s[:n]
            counts.append(n)
        return torch.from_numpy(out).to(self.device), counts

    def _process(self, raw: torch.Tensor, counts: list, frame: int):
        cfg = self.config
        if frame == 0:
            init_lanes(self.state, cfg, raw, counts)
            return None
        step_lanes(self.state, cfg, raw, counts, frame, self._nn1)
        if frame % cfg.loop_check_every == 0 and frame > cfg.loop_start_frame:
            return loop_tick_lanes(self.state, cfg, frame, self._optimize_midrun)
        return None

    def push_scans(self, scans, sync_info: bool = False) -> Optional[int]:
        """One scan per sequence. With ``sync_info`` a loop tick returns the
        number of loops it accepted over all lanes."""
        raw, counts = self.pad_scans(scans)
        dets = self._process(raw, counts, self._frame)
        self._frame += 1
        if not sync_info or dets is None:
            return None
        return sum(int(d.accepted.sum()) for d in dets)

    def preload(self, seqs: list, frame0: int = 0) -> None:
        """Upload every lane's prepared scans once, as a (B, T, cap, 3)
        store (row i is frame ``frame0 + i``). ``seqs``: B equal-length
        lists of (n_i, 3) scans."""
        if len(seqs) != self.batch:
            raise ValueError(f"{len(seqs)} sequences for {self.batch} lanes")
        T = len(seqs[0])
        if any(len(s) != T for s in seqs):
            raise ValueError("lanes must be equal length")
        cap = self._scan_cap
        store = torch.zeros((self.batch, T, cap, 3), dtype=torch.float32,
                            device=self.device)
        counts = np.zeros((self.batch, T), np.int64)
        for b, seq in enumerate(seqs):
            for i, s in enumerate(seq):
                m = min(len(s), cap)
                store[b, i, :m] = torch.from_numpy(
                    np.ascontiguousarray(s[:m], np.float32))
                counts[b, i] = m
        self._resident = (store, counts, frame0)

    def run_preloaded(self) -> None:
        """Process every preloaded scan on every lane (the same math and
        cadence as ``push_scans``, no host-to-device transfer per scan)."""
        if self._resident is None:
            raise ValueError("call preload(seqs) first")
        store, counts, row0 = self._resident
        if self._frame < row0:
            raise ValueError(f"preload(frame0={row0}) starts past engine "
                             f"frame {self._frame}")
        for f in range(self._frame, row0 + store.shape[1]):
            r = f - row0
            self._process(store[:, r], counts[:, r].tolist(), f)
        self._frame = row0 + store.shape[1]

    def flush(self) -> None:
        """Nothing is buffered (every scan is processed when pushed); kept
        so that callers of either engine read the same."""

    def finalize(self) -> list:
        """Per lane: the float64 pose-graph LM to convergence, then the
        occupancy rebuild (``SlamEngine.finalize``). Returns each lane's
        optimize result."""
        out = []
        for b in range(self.batch):
            lane = pipe.lane_state(self.state, b)
            out.append(pipe.finalize_state(lane, self.config))
            pipe.set_lane(self.state, b, lane)
        return out

    # -- results -----------------------------------------------------------

    @property
    def n_frames(self) -> int:
        return self._frame

    def trajectories(self) -> np.ndarray:
        """(B, n, 4, 4) poses, n the longest lane (a copy)."""
        n = max(self.state.n_poses)
        return self.state.poses[:, :n].cpu().numpy().copy()

    def metrics(self) -> list:
        """``SlamEngine.metrics()`` of each lane."""
        return [pipe.state_metrics(pipe.lane_state(self.state, b))
                for b in range(self.batch)]

    def loop_pairs(self) -> list:
        """Each lane's accepted (query, match) frame pairs."""
        return [pipe.loop_pairs(pipe.lane_state(self.state, b))
                for b in range(self.batch)]
