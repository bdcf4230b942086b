"""Batched multi-sequence SLAM (port of ``lidar_slam_tpu/parallel/batched.py``;
the configuration ladder's rung 4: several sequences at once on one card,
or spread over the ``seq`` axis of a device mesh).

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
mid-run pose-graph chunk and finalize (each lane's LM to convergence, then
the occupancy rebuild, as ``SlamEngine.finalize``: one float64 Woodbury LM
for the default config, the float32 chunks and float64 backstop of
``pose_graph.optimize_chunked`` for any other solver).

Semantics follow the JAX batched engine, which differ from the single
engine's in two places (ROADMAP.md, Queue 3): the mid-run optimize is gated
on ``pending_optimize`` (a lane whose chunk did not converge runs again at
every tick) and optimizes the whole graph (no ``window_loops``); with
``optimize_midrun=False`` (``--mode fast``) no chunk runs and the lanes
equal the single engine. As in the JAX batched engine, scans carry no host
normals: the normals are always estimated on the device. Each cadence tick
runs right after its frame; the JAX engine's dispatch blocks, multi-tick
bunching and emulated-f64 finalize tier exist for the TPU and are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..models import loop_closure as lc
from ..models import pipeline as pipe
from ..models import pose_graph as pg
from ..ops import knn_cuda, se3
from ..ops.icp import icp_point_to_plane, lane_compose
from ..ops.occupancy import update_occupancy
from ..ops.voxel import voxel_downsample
from ..types import PointCloud
from .mesh import Mesh


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

    new_pose = se3.orthonormalize(lane_compose(state.poses[:, frame - 1], delta))
    state.poses[:, frame] = new_pose
    g = state.pg  # pose_graph.add_odometry over lanes
    g.poses[:, frame] = lane_compose(g.poses[:, frame - 1], delta)
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


def optimize_chunk(state: pipe.SlamState, config: SlamConfig) -> bool:
    """One bounded float32 pose-graph chunk (``inline_max_iterations``) over
    a one-lane state's WHOLE graph, in place (the JAX package's
    ``make_optimize_fn``); returns whether it converged."""
    res = pg.optimize(state.pg.replace(poses=state.poses), config.pg,
                      max_iterations=config.pg.inline_max_iterations)
    state.poses[: state.n_poses] = res.poses[: state.n_poses]
    return bool(res.converged)


def gated_optimize(state: pipe.SlamState, config: SlamConfig) -> None:
    """The JAX batched engine's mid-run optimize (``make_gated_optimize``),
    in place: every lane with ``pending_optimize`` set runs one
    :func:`optimize_chunk`, and stays pending while it does not converge."""
    for b, pending in enumerate(state.pending_optimize):
        if pending:
            state.pending_optimize[b] = not optimize_chunk(
                pipe.lane_state(state, b), config)


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


def make_batched_fns(config: SlamConfig, optimize_midrun: bool = True):
    """The JAX package's ``make_batched_fns`` programs over a lane-stacked
    state, in place: ``init(state, raw, counts)``, ``step(state, raw,
    counts, frame)``, ``loop(state, frame) -> detections`` (with the gated
    mid-run optimize unless ``optimize_midrun`` is off), ``optimize(state)``
    (one :func:`optimize_chunk` on every lane, which sets its
    ``pending_optimize``) and ``finalize(state) -> results`` (each lane's
    ``pipeline.finalize_state``: the LM to convergence and the occupancy
    rebuild). Placing lanes on a
    mesh is ``BatchedSlamEngine(mesh=)``'s part: it runs these on each
    group."""
    nn1 = pipe.resolve_nn1(config)

    def init(state, raw, counts):
        init_lanes(state, config, raw, counts)

    def step(state, raw, counts, frame):
        step_lanes(state, config, raw, counts, frame, nn1)

    def loop(state, frame):
        return loop_tick_lanes(state, config, frame, optimize_midrun)

    def optimize(state):
        for b in range(len(state.n_poses)):
            state.pending_optimize[b] = not optimize_chunk(
                pipe.lane_state(state, b), config)

    def finalize(state):
        out = []
        for b in range(len(state.n_poses)):
            lane = pipe.lane_state(state, b)
            out.append(pipe.finalize_state(lane, config))
            pipe.set_lane(state, b, lane)
        return out

    return init, step, loop, optimize, finalize


def _cat_states(states: list, device):
    """Lane-stacked states -> one, on ``device`` (lanes in order)."""
    first = states[0]
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in states]
        if dataclasses.is_dataclass(vals[0]):
            kw[f.name] = _cat_states(vals, device)
        elif isinstance(vals[0], torch.Tensor):
            kw[f.name] = torch.cat([v.to(device) for v in vals])
        else:
            kw[f.name] = [x for v in vals for x in v]
    return type(first)(**kw)


def _lanes(state, lo: int, hi: int, device):
    """Lanes ``[lo, hi)`` of a lane-stacked state, copied to ``device``."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _lanes(v, lo, hi, device)
        elif isinstance(v, torch.Tensor):
            kw[f.name] = v[lo:hi].to(device, copy=True)
        else:
            kw[f.name] = list(v[lo:hi])
    return type(state)(**kw)


class BatchedSlamEngine:
    """Run ``batch`` sequences in lockstep.

    ``device``: the card by default; without CUDA that raises, and the CPU
    must be asked for (as the tests do). ``optimize_midrun`` as in the JAX
    engine (the command line passes ``config.optimize_midrun``).

    ``mesh`` (a :class:`~.mesh.Mesh`) spreads the lanes over its
    ``seq_axis``, as the JAX engine's batch-axis sharding does: the lanes
    are split into contiguous groups, one per ``seq`` index (``batch`` must
    divide evenly), and each group's state lives on that index's device
    (the first along the mesh's other axes); ``device`` is then unused.
    Every call fans out to the groups and gathers their results, which keep
    the shapes and values of the engine without a mesh. A group's mid-run
    optimize runs when any lane of the group is pending, and optimizes only
    its pending lanes: a lane with nothing pending keeps its poses
    (``lidar_slam_tpu/parallel/batched.py:68-69``), so no lane's result
    depends on the grouping. As in the JAX engine, the nearest-neighbour
    search is not sharded over the mesh's other axes.

    ``state`` is the lane-stacked state: the live one without a mesh, a
    gathered copy on the first group's device with one (assigning it
    splits it over the groups)."""

    def __init__(self, config: SlamConfig, batch: int, device="cuda",
                 optimize_midrun: bool = True, mesh: Optional[Mesh] = None,
                 seq_axis: str = "seq"):
        if mesh is None:
            devices = [torch.device(device)]
        else:
            if not isinstance(mesh, Mesh):
                raise TypeError("mesh must be a lidar_slam_tpu_torch.parallel."
                                f"Mesh (make_mesh), got {type(mesh).__name__}")
            if seq_axis not in mesh.axis_names:
                raise ValueError(f"mesh axes {mesh.axis_names} have no "
                                 f"{seq_axis!r} axis to spread the lanes over")
            devices = mesh.axis_devices(seq_axis)
            if batch % len(devices):
                raise ValueError(f"{batch} lanes do not split evenly over the "
                                 f"mesh's {len(devices)} {seq_axis!r} groups")
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedSlamEngine runs on an NVIDIA GPU by default and CUDA "
                "is not available; pass device='cpu' to run on the CPU")
        pipe.pin_f32_matmuls()
        self.config = config
        self.batch = batch
        self.mesh = mesh
        self.device = devices[0]
        per = batch // len(devices)
        self._groups = [(dev, g * per, (g + 1) * per)
                        for g, dev in enumerate(devices)]
        self._init, self._step, self._loop, _, self._finalize = (
            make_batched_fns(config, optimize_midrun))
        self._resident: Optional[tuple] = None
        self.reset()

    def reset(self) -> None:
        """Blank the state for another run in this process; preloaded scans
        stay on the device."""
        self._states = [init_states(self.config, hi - lo, dev)
                        for dev, lo, hi in self._groups]
        self._frame = 0

    @property
    def state(self) -> pipe.SlamState:
        if len(self._states) == 1:
            return self._states[0]
        return _cat_states(self._states, self.device)

    @state.setter
    def state(self, value: pipe.SlamState) -> None:
        if len(self._groups) == 1:
            self._states = [value]
        else:
            self._states = [_lanes(value, lo, hi, dev)
                            for dev, lo, hi in self._groups]

    # -- scan feeding ------------------------------------------------------

    @property
    def _scan_cap(self) -> int:
        cfg = self.config
        return cfg.max_points if cfg.host_voxelize else cfg.max_raw_points

    def pad_scans(self, scans) -> list:
        """One scan per lane, padded to the input capacity (``max_points``
        under ``host_voxelize``, else ``max_raw_points``, as
        ``SlamEngine.pad_scan``): each group's ``(B_g, cap, 3)`` scans on
        its device, with their counts."""
        if len(scans) != self.batch:
            raise ValueError(f"{len(scans)} scans for {self.batch} lanes")
        cap = self._scan_cap
        out = np.zeros((self.batch, cap, 3), np.float32)
        counts = []
        for b, s in enumerate(scans):
            n = min(len(s), cap)
            out[b, :n] = s[:n]
            counts.append(n)
        return [(torch.from_numpy(out[lo:hi]).to(dev), counts[lo:hi])
                for dev, lo, hi in self._groups]

    def _process(self, inputs: list, frame: int):
        """Frame ``frame`` of every group (``inputs``: each group's scans
        and counts); a loop tick's detections of all lanes, else None."""
        cfg = self.config
        tick = frame % cfg.loop_check_every == 0 and frame > cfg.loop_start_frame
        dets = []
        for state, (raw, counts) in zip(self._states, inputs):
            if frame == 0:
                self._init(state, raw, counts)
                continue
            self._step(state, raw, counts, frame)
            if tick:
                dets += self._loop(state, frame)
        return dets if frame > 0 and tick else None

    def push_scans(self, scans, sync_info: bool = False) -> Optional[int]:
        """One scan per sequence. With ``sync_info`` a loop tick returns the
        number of loops it accepted over all lanes."""
        dets = self._process(self.pad_scans(scans), self._frame)
        self._frame += 1
        if not sync_info or dets is None:
            return None
        return sum(int(d.accepted.sum()) for d in dets)

    def preload(self, seqs: list, frame0: int = 0) -> None:
        """Upload every lane's prepared scans once, as a (B_g, T, cap, 3)
        store on each group's device (row i is frame ``frame0 + i``).
        ``seqs``: B equal-length lists of (n_i, 3) scans."""
        if len(seqs) != self.batch:
            raise ValueError(f"{len(seqs)} sequences for {self.batch} lanes")
        T = len(seqs[0])
        if any(len(s) != T for s in seqs):
            raise ValueError("lanes must be equal length")
        cap = self._scan_cap
        stores = []
        for dev, lo, hi in self._groups:
            store = torch.zeros((hi - lo, T, cap, 3), dtype=torch.float32,
                                device=dev)
            counts = np.zeros((hi - lo, T), np.int64)
            for b, seq in enumerate(seqs[lo:hi]):
                for i, s in enumerate(seq):
                    m = min(len(s), cap)
                    store[b, i, :m] = torch.from_numpy(
                        np.ascontiguousarray(s[:m], np.float32))
                    counts[b, i] = m
            stores.append((store, counts))
        self._resident = (stores, T, frame0)

    def run_preloaded(self) -> None:
        """Process every preloaded scan on every lane (the same math and
        cadence as ``push_scans``, no host-to-device transfer per scan)."""
        if self._resident is None:
            raise ValueError("call preload(seqs) first")
        stores, T, row0 = self._resident
        if self._frame < row0:
            raise ValueError(f"preload(frame0={row0}) starts past engine "
                             f"frame {self._frame}")
        for f in range(self._frame, row0 + T):
            r = f - row0
            self._process([(store[:, r], counts[:, r].tolist())
                           for store, counts in stores], f)
        self._frame = row0 + T

    def flush(self) -> None:
        """Nothing is buffered (every scan is processed when pushed); kept
        so that callers of either engine read the same."""

    def finalize(self) -> list:
        """Per lane: the pose-graph LM to convergence, then the occupancy
        rebuild (``pipeline.finalize_state``, as ``SlamEngine.finalize``).
        Returns each lane's optimize result."""
        return [res for state in self._states for res in self._finalize(state)]

    # -- results -----------------------------------------------------------

    @property
    def n_frames(self) -> int:
        return self._frame

    def _lanes_of_states(self):
        """Every lane as a one-lane state, in lane order."""
        for state in self._states:
            for b in range(len(state.n_poses)):
                yield pipe.lane_state(state, b)

    def trajectories(self) -> np.ndarray:
        """(B, n, 4, 4) poses, n the longest lane (a copy)."""
        n = max(max(s.n_poses) for s in self._states)
        return np.concatenate([s.poses[:, :n].cpu().numpy()
                               for s in self._states])

    def metrics(self) -> list:
        """``SlamEngine.metrics()`` of each lane."""
        return [pipe.state_metrics(lane) for lane in self._lanes_of_states()]

    def loop_pairs(self) -> list:
        """Each lane's accepted (query, match) frame pairs."""
        return [pipe.loop_pairs(lane) for lane in self._lanes_of_states()]

    # -- checkpoint / resume -------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Write the lane-stacked state to ``path`` (.npz): the JAX
        package's checkpoint format with a leading lane axis on every leaf
        (what its ``save_state`` writes for a batched state). A checkpoint
        written with a mesh holds every lane and loads without one."""
        from ..utils.checkpoint import save_state

        save_state(path, self.state, extra={"frame": self._frame})

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of ``batch`` lanes written under the same
        config, with or without a mesh; the next scans pushed are frame
        ``n_frames``."""
        from ..utils.checkpoint import load_state

        template = (self._states[0] if len(self._states) == 1
                    else _cat_states(self._states, "meta"))
        self.state, extra = load_state(path, template, device=self.device)
        self._frame = int(extra.get("frame", 0))
