"""The output check: what the window produced, held to the plain reference.

The reference (``reference/``) works every stage out again from the raw
scans of the run's seed and the configuration file, and reads the
program's outputs only to judge them. The numbers compared, each against
its limit in the cell's workload file:

- ``cloud_gap_m``: every frame's prepared cloud (host or device
  voxelizer) against the reference's voxelization of the raw scan, the
  widest coordinate gap (1e30 where the occupied rows differ);
- ``normal_p99_deg``: the sampled frames' normals against the reference's
  on the reference's cloud, the 99th percentile of the angle over valid
  rows (sign ignored);
- ``odom_frames_off``: of ``ODOMETRY_FRAMES`` frames sampled from the
  seed, those whose odometry factor parts from the reference's: the delta
  by more than ``odom_frame_gap_m`` (the widest displacement of a cloud
  point between the two deltas; any where one takes the frame and the
  other skips it), or the factor's scale (1 + 10 x the ICP's final error)
  by more than ``odom_frame_scale_gap`` of the reference's. The reference
  registers its own cloud onto its own previous cloud and normals, started
  where the program started (its previous accepted delta under
  ``warm_start``): the one stage followed from the program's own state. A
  count and not the widest gap, because an ICP that stops on a tolerance
  of its error's change stops an iteration earlier or later on a last-bit
  difference, and a few frames then part by a step, or by a whole delta
  where that flips its acceptance;
- ``loop_mismatch``: loop ticks whose accepted match frames differ from the
  reference's retrieval and verification on the reference's keyframe DB
  (every tick whose retrieval finds no candidate, and ``VERIFY_TICKS``
  sampled from those that do);
- ``loops_off``: of the loops both accept on those ticks, those whose
  transform parts from the reference's by more than ``loop_frame_gap_m``
  over the query cloud, for the reason above. Loop factors carry no weight
  of their own (the configuration's sigmas);
- ``traj_cost_excess``: how far the finalized trajectory is from a minimum
  of the program's own factor graph (its odometry factors, scales and loop
  factors, judged above on their samples): the drop of the graph's cost
  when the reference's Levenberg-Marquardt descends from it to a relative
  decrease of 1e-12, relative to the cost reached (or to 1, a cost of one
  sigma, where the graph is consistent and its least cost is near 0);
- ``grid_cells``: cells of the finalized occupancy grid that differ from the
  reference's rebuild from the finalized poses and the reference's clouds.

``judge(..., control=True)`` puts the reference in the program's place,
one precision below the configuration's (``reference/prec.py``), each
stage on the reference's own inputs: the control the limits are set
against."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .reference import loops as rl
from .reference.config import namespace
from .reference.normals import adaptive_normals, angle_deg
from .reference.occupancy import rebuild
from .reference.pose_graph import Graph, optimum
from .reference.prec import FP32, TF32
from .reference.step import odometry
from .reference.voxel import voxelize
from .window import is_tick

MISMATCH = 1e30
ODOMETRY_FRAMES = 32
VERIFY_TICKS = 6
NUMBERS = ("cloud_gap_m", "normal_p99_deg", "odom_frames_off", "loop_mismatch",
           "loops_off", "traj_cost_excess", "grid_cells")
PER_ITEM = {"odom_frames_off": ("odom_frame_gap_m", "odom_frame_scale_gap"),
            "loops_off": ("loop_frame_gap_m",)}     # a count -> its items' limits
LIMITS = NUMBERS + tuple(k for v in PER_ITEM.values() for k in v)


@dataclass
class ProgramOutputs:
    """What the last drive of the window left in the engine's state, copied
    out of it so that the rest of the state can be freed."""

    clouds: torch.Tensor       # (n, N, 3)
    masks: torch.Tensor        # (n, N)
    normals: torch.Tensor      # (n, N, 3)
    odom_rel: torch.Tensor     # (n, 4, 4)
    odom_valid: torch.Tensor   # (n,)
    odom_scale: torch.Tensor   # (n,)
    loop_from: torch.Tensor    # (L,)
    loop_to: torch.Tensor      # (L,)
    loop_rel: torch.Tensor     # (L, 4, 4)
    poses: torch.Tensor        # (n, 4, 4) finalized
    grid: torch.Tensor         # (D, D)

    @classmethod
    def from_engine(cls, engine) -> "ProgramOutputs":
        st, n = engine.state, engine.n_frames
        g, L = st.pg, st.pg.n_loops
        return cls(
            clouds=st.db.clouds[:n].clone(), masks=st.db.cloud_mask[:n].clone(),
            normals=st.db.normals[:n].clone(), odom_rel=g.odom_rel[:n].clone(),
            odom_valid=g.odom_valid[:n].clone(), odom_scale=g.odom_scale[:n].clone(),
            loop_from=g.loop_from[:L].clone(), loop_to=g.loop_to[:L].clone(),
            loop_rel=g.loop_rel[:L].clone(), poses=st.poses[:n].clone(),
            grid=st.grid.clone())

    def nonfinite_poses(self) -> int:
        return int((~torch.isfinite(self.poses.reshape(len(self.poses), -1))
                    .all(1)).sum())


def displacement(A: torch.Tensor, B: torch.Tensor, pts: torch.Tensor) -> float:
    """Widest |A p - B p| over the points (in float64)."""
    if pts.shape[0] == 0:
        return 0.0
    D = (A.double() - B.double())
    d = pts.double() @ D[:3, :3].T + D[:3, 3]
    return float(torch.linalg.norm(d, dim=1).max())


class Reference:
    """The reference's stages over one drive, each worked out once."""

    def __init__(self, cfg, raw: list, device):
        self.cfg, self.raw, self.device = cfg, raw, device
        self.n = len(raw)
        self._clouds = None
        self._normals = {}

    def cloud_all(self, p=FP32):
        cfg = self.cfg
        pts = torch.zeros((self.n, cfg.max_points, 3), device=self.device)
        mask = torch.zeros((self.n, cfg.max_points), dtype=torch.bool,
                           device=self.device)
        cap = cfg.max_raw_points
        for f, r in enumerate(self.raw):
            x = torch.from_numpy(np.ascontiguousarray(r[:cap])).to(self.device)
            pts[f], mask[f] = voxelize(x, cfg.voxel_size, cfg.max_points,
                                       device_keys=not cfg.host_voxelize, p=p)
        return pts, mask

    @property
    def clouds(self):
        if self._clouds is None:
            self._clouds = self.cloud_all()
        return self._clouds

    def normals(self, f: int, p=FP32):
        if p is FP32 and f in self._normals:
            return self._normals[f]
        pts, mask = self.clouds
        n = adaptive_normals(pts[f], mask[f], self.cfg, p)
        if p is FP32:
            self._normals[f] = n
        return n

    def odometry(self, f: int, prev_delta, p=FP32):
        pts, mask = self.clouds
        return odometry(self.cfg, pts[f], mask[f], pts[f - 1], mask[f - 1],
                        self.normals(f - 1), prev_delta, p)

    def descriptors(self):
        pts, mask = self.clouds
        desc = torch.stack([rl.descriptor(pts[f], mask[f], self.cfg.sc)
                            for f in range(self.n)])
        norm = torch.sqrt((desc * desc).sum((1, 2)))
        in_db = (mask.sum(1) >= self.cfg.min_points)
        in_db[0] = False
        return desc, norm, in_db

    def verify(self, q: int, cand, shifts, p=FP32):
        pts, mask = self.clouds
        return rl.verify(pts[q], mask[q], cand, lambda i: pts[i], lambda i: mask[i],
                         lambda i: torch.stack([self.normals(int(k)) for k in i]),
                         shifts, self.cfg.lc, self.cfg.sc,
                         rl.verify_icp_config(self.cfg.lc), p)


def judge(cell, raw: list, out: ProgramOutputs, seed: int, device,
          control: bool = False, details: dict | None = None):
    """``(correct, [(name, value, limit), ...])`` for one run; ``details``,
    where given, receives each sampled frame's and loop's gaps."""
    cfg = namespace(cell.config["slam_config"])
    if cfg.normal_method != "adaptive" or cfg.host_normals:
        raise NotImplementedError("the reference has adaptive device normals only")
    ref = Reference(cfg, raw, device)
    n = ref.n
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x51AB])
    P = TF32
    nums = {}

    pts, mask = ref.clouds
    c_pts, c_mask = ref.cloud_all(P) if control else (out.clouds, out.masks)
    if not torch.equal(c_mask, mask):
        nums["cloud_gap_m"] = MISMATCH
    else:
        d = (c_pts - pts).abs().amax(-1)
        nums["cloud_gap_m"] = float(torch.where(mask, d, torch.zeros_like(d)).max())

    lim = cell.limits
    k = min(ODOMETRY_FRAMES, n - 1)
    frames = sorted(rng.choice(np.arange(1, n), size=k, replace=False).tolist())
    angles, odom, scale_gaps = [], [], []
    for f in frames:
        for g in (f - 1, f):
            rn = ref.normals(g)
            cn = ref.normals(g, P) if control else out.normals[g]
            m = mask[g]
            angles.append(angle_deg(cn[m], rn[m]))
        prev = out.odom_rel[f - 1]
        dr, okr, sr = ref.odometry(f, prev)
        if control:
            dc, okc, sc = ref.odometry(f, prev, P)
        else:
            dc, okc = out.odom_rel[f], bool(out.odom_valid[f])
            sc = float(out.odom_scale[f])
        odom.append(MISMATCH if okr != okc else displacement(dc, dr, pts[f][mask[f]]))
        scale_gaps.append(abs(sc - sr) / sr)
    a = torch.cat(angles)
    nums["normal_p99_deg"] = float(torch.quantile(a.float(), 0.99)) if a.numel() else 0.0
    nums["odom_frames_off"] = float(sum(
        g > lim["odom_frame_gap_m"] or sg > lim["odom_frame_scale_gap"]
        for g, sg in zip(odom, scale_gaps)))

    desc, dnorm, in_db = ref.descriptors()
    ticks = [q for q in range(n) if is_tick(cfg, q)]
    with_cand, mismatch, loop_gaps = [], 0, []
    for q in ticks:
        cand, _, shifts = rl.candidates(q, desc, dnorm, in_db, cfg.lc)
        prog_q = {} if control else {
            int(a): out.loop_rel[i] for i, (a, b) in
            enumerate(zip(out.loop_from.tolist(), out.loop_to.tolist())) if b == q}
        if len(cand) == 0:
            mismatch += int(bool(prog_q))
        else:
            with_cand.append((q, cand, shifts, prog_q))
    pick = rng.permutation(len(with_cand))[:VERIFY_TICKS]
    for i in sorted(pick.tolist()):
        q, cand, shifts, prog_q = with_cand[i]
        acc_r = dict(ref.verify(q, cand, shifts))
        acc_c = dict(ref.verify(q, cand, shifts, P)) if control else prog_q
        if set(acc_r) != set(acc_c):
            mismatch += 1
        for m_, T in acc_r.items():
            if m_ in acc_c:
                loop_gaps.append(displacement(acc_c[m_], T, pts[q][mask[q]]))
    nums["loop_mismatch"] = float(mismatch)
    nums["loops_off"] = float(sum(g > lim["loop_frame_gap_m"] for g in loop_gaps))
    if details is not None:
        details.update(frames=frames, odom_gaps=odom, scale_gaps=scale_gaps,
                       loop_gaps=loop_gaps)

    factors = (out.odom_rel, out.odom_valid, out.odom_scale, out.loop_from,
               out.loop_to, out.loop_rel, cfg.pg)
    graph = Graph(*factors)
    if control:
        chain = [torch.eye(4, device=out.poses.device)]
        for f in range(1, n):
            chain.append(P.mm(chain[-1], out.odom_rel[f]))
        cand_poses = optimum(Graph(*factors, P), torch.stack(chain))
    else:
        cand_poses = out.poses
    start = cand_poses.double()
    e0 = graph.cost(start)
    e1 = graph.cost(optimum(graph, start))
    nums["traj_cost_excess"] = (e0 - e1) / max(e1, 1.0) if math.isfinite(e0) \
        else MISMATCH

    grid_r = rebuild(out.poses, pts, mask, cfg.grid)
    grid_c = rebuild(out.poses, pts, mask, cfg.grid, P) if control else out.grid
    nums["grid_cells"] = float((grid_c != grid_r).sum())

    numbers = [(name, nums[name], lim.get(name)) for name in NUMBERS]
    correct = all(lim is not None and not math.isnan(v) and v <= lim
                  for _, v, lim in numbers)
    return correct, numbers
