"""The port's host-side data path against the JAX package's on the same
files: the numpy-only I/O copy, the native frame loader, the dataset
generator, RPE and the export helpers. Everything here is exact (the same
bytes in, the same arithmetic), so results are compared for equality."""

import filecmp
import os

import numpy as np
import pytest

from lidar_slam_tpu.config import OccupancyGridConfig as JGridConfig
from lidar_slam_tpu.ops import occupancy as jocc
from lidar_slam_tpu.utils import dataset as jdataset
from lidar_slam_tpu.utils import export as jexport
from lidar_slam_tpu.utils import io as jio
from lidar_slam_tpu.utils import metrics as jmetrics
from lidar_slam_tpu.utils import native as jnative
from lidar_slam_tpu_torch.config import OccupancyGridConfig
from lidar_slam_tpu_torch.ops import occupancy
from lidar_slam_tpu_torch.utils import dataset, export, io, metrics, native

from jax_native import jax_native  # noqa: F401  (autouse fixture)


def _write_ascii_ply(path, pts, crlf=False):
    nl = "\r\n" if crlf else "\n"
    # x y z first: the native ASCII parser reads the first three columns
    head = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
            "property float x", "property float y", "property float z",
            "property float intensity", "end_header"]
    rows = [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 0.5" for p in pts]
    with open(path, "w", newline="") as f:
        f.write(nl.join(head + rows) + nl)


def _write_double_ply(path, pts):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property uchar flag\nproperty double x\nproperty double y\n"
        "property double z\nend_header\n"
    )
    rec = np.zeros(len(pts), dtype=[("flag", "u1"), ("x", "<f8"),
                                    ("y", "<f8"), ("z", "<f8")])
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


@pytest.fixture
def scan_dir(tmp_path, rng):
    """A directory of frames in every format the readers take."""
    d = tmp_path / "frames"
    d.mkdir()
    pts = [rng.normal(size=(n, 3)).astype(np.float32) * 20.0
           for n in (700, 513, 64, 1200, 300, 450)]
    jio.save_ply(str(d / "000003.ply"), pts[0])
    jio.save_ply(str(d / "000001.ply"), pts[1], rng.uniform(size=513))
    _write_ascii_ply(str(d / "000010.ply"), pts[2])
    _write_ascii_ply(str(d / "000002.ply"), pts[2], crlf=True)
    _write_double_ply(str(d / "000007.ply"), pts[3].astype(np.float64))
    np.concatenate([pts[4], np.ones((300, 1), np.float32)], 1).tofile(
        str(d / "000005.bin"))
    np.concatenate([pts[5], np.ones((450, 1), np.float32)], 1).tofile(
        str(d / "000004.bin"))
    (d / "notes.txt").write_text("not a frame")
    (d / "scan.ply").write_text("no timestamp")
    return str(d)


def test_io_copy_reads_what_the_original_reads(scan_dir):
    """ply (binary, with intensity, ASCII, CRLF header, double), bin, and
    the discovery order: equal to the original's on the same files."""
    frames = io.discover_frames(scan_dir)
    assert frames == jio.discover_frames(scan_dir)
    assert [t for t, _ in frames] == [1, 2, 3, 4, 5, 7, 10]
    for _, path in frames:
        a, b = io.load_scan(path), jio.load_scan(path)
        assert a.dtype == np.float32 and a.shape == b.shape and len(a) > 0
        np.testing.assert_array_equal(a, b)
    assert io.extract_timestamp("x_000123.ply") == 123
    assert io.extract_timestamp("scan.ply") == -1
    v = io.load_scan(frames[0][1])
    np.testing.assert_array_equal(io.voxel_downsample_np(v, 2.0),
                                  jio.voxel_downsample_np(v, 2.0))
    assert io.voxel_downsample_np(v, 0.0) is v


def test_save_ply_and_convert_write_the_same_bytes(tmp_path, scan_dir, rng):
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    inten = rng.uniform(size=257).astype(np.float32)
    for name, kw in (("a", {}), ("b", {"intensity": inten})):
        io.save_ply(str(tmp_path / f"{name}_t.ply"), pts, **kw)
        jio.save_ply(str(tmp_path / f"{name}_j.ply"), pts, **kw)
        assert filecmp.cmp(tmp_path / f"{name}_t.ply", tmp_path / f"{name}_j.ply",
                           shallow=False)
    np.testing.assert_array_equal(io.load_ply(str(tmp_path / "b_t.ply")), pts)
    n = io.convert_bin_to_ply(os.path.join(scan_dir, "000005.bin"),
                              str(tmp_path / "c_t.ply"))
    assert n == jio.convert_bin_to_ply(os.path.join(scan_dir, "000005.bin"),
                                       str(tmp_path / "c_j.ply")) == 300
    assert filecmp.cmp(tmp_path / "c_t.ply", tmp_path / "c_j.ply", shallow=False)
    assert io.convert_directory(scan_dir, str(tmp_path / "out_t")) == 2
    assert jio.convert_directory(scan_dir, str(tmp_path / "out_j")) == 2
    for name in ("000004.ply", "000005.ply"):
        assert filecmp.cmp(tmp_path / "out_t" / name, tmp_path / "out_j" / name,
                           shallow=False)


def test_native_reader_matches_numpy_reader(scan_dir):
    for _, path in io.discover_frames(scan_dir):
        np.testing.assert_array_equal(native.load_scan_native(path),
                                      io.load_scan(path))
    with pytest.raises(RuntimeError, match="missing.ply"):
        native.load_scan_native(os.path.join(scan_dir, "missing.ply"))


@pytest.mark.parametrize("mode", ["raw", "voxel", "normals", "start"])
def test_frame_loader_matches_jax_loader(scan_dir, mode):
    """``get``, ``get_with_normals`` and ``start=`` against the JAX
    package's loader on the same directory: exact."""
    paths = [p for _, p in io.discover_frames(scan_dir)]
    kw = {
        "raw": dict(cap=1024),
        "voxel": dict(cap=256, voxel=2.0, raw_cap=2048, threads=3),
        "normals": dict(cap=512, voxel=1.0, raw_cap=2048, normals_radius=6.0),
        "start": dict(cap=1024, window=2, start=4),
    }[mode]
    first = kw.get("start", 0)
    with native.FrameLoader(paths, **kw) as lt, \
            jnative.FrameLoader(paths, **kw) as lj:
        for i in range(first, len(paths)):
            if mode == "normals":
                (p_t, n_t), (p_j, n_j) = lt.get_with_normals(i), lj.get_with_normals(i)
                np.testing.assert_array_equal(n_t, n_j)
                np.testing.assert_array_equal(
                    n_t, native.normals_radius_host(p_t, 6.0))
            else:
                p_t, p_j = lt.get(i), lj.get(i)
            assert len(p_t) > 0
            np.testing.assert_array_equal(p_t, p_j)
            if mode == "voxel":
                raw = io.load_scan(paths[i])
                np.testing.assert_array_equal(
                    p_t, native.voxel_downsample_host(raw, 2.0, 256))


def test_frame_loader_raises_on_a_failed_read(scan_dir, tmp_path):
    """No silent second path: a frame that cannot be read raises with its
    path, where the JAX loader would fall through to the numpy reader."""
    bad = str(tmp_path / "000001.ply")
    paths = [io.discover_frames(scan_dir)[0][1], bad]
    with native.FrameLoader(paths, cap=1024) as loader:
        assert len(loader.get(0)) == 513
        with pytest.raises(RuntimeError, match="000001.ply"):
            loader.get(1)
    with pytest.raises(ValueError, match="closed"):
        loader.get(0)
    with native.FrameLoader(paths[:1], cap=1024) as loader:
        with pytest.raises(ValueError, match="normals_radius"):
            loader.get_with_normals(0)
        with pytest.raises(IndexError):
            loader.get(3)


@pytest.mark.parametrize("fmt", ["ply", "bin"])
def test_make_dataset_writes_identical_files(tmp_path, fmt):
    kw = dict(n_frames=6, seed=3, max_points=1500, fmt=fmt)
    _, gt_t = dataset.make_dataset(str(tmp_path / "t"), **kw)
    _, gt_j = jdataset.make_dataset(str(tmp_path / "j"), **kw)
    np.testing.assert_array_equal(gt_t, gt_j)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == [f"{i:06d}.{fmt}" for i in range(6)] + ["poses_gt.txt"]
    for name in names:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name
    path = str(tmp_path / "t" / "poses_gt.txt")
    np.testing.assert_array_equal(dataset.load_gt_poses(path),
                                  jdataset.load_gt_poses(path))


def test_rpe_copy_matches(rng):
    gt = jdataset.generate_trajectory(40)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(40, 3)).astype(np.float32) * 0.1
    assert metrics.rpe(est, gt) == jmetrics.rpe(est, gt)
    assert metrics.rpe(est, gt, delta=5) == jmetrics.rpe(est, gt, delta=5)


@pytest.mark.parametrize("case", ["blob", "edge", "empty"])
def test_grid_to_message_matches(case):
    kw = dict(grid_dim=64, resolution=0.25, origin_x=3.0, origin_y=-2.0)
    grid = np.zeros((64, 64), np.uint8)
    if case == "blob":
        grid[20:25, 30:41] = 1
    elif case == "edge":  # the margin is clipped at the grid's border
        grid[0, 2] = grid[63, 61] = 1
    a = occupancy.grid_to_message(grid, OccupancyGridConfig(**kw))
    b = jocc.grid_to_message(grid, JGridConfig(**kw))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["data"].dtype == np.int8


class _Engine:
    """The few engine methods the exporters read, over fixed arrays."""

    def __init__(self, rng, grid_config):
        self.config = type("C", (), {"grid": grid_config})()
        self._traj = jdataset.generate_trajectory(12)
        self._map = rng.normal(size=(500, 3)).astype(np.float32)
        self._grid = (rng.uniform(size=(64, 64)) > 0.9).astype(np.uint8)

    def trajectory(self):
        return self._traj

    def global_map(self, max_points_per_frame=None):
        return self._map[:: 2 if max_points_per_frame else 1]

    def occupancy(self):
        return self._grid

    def metrics(self):
        n = len(self._traj)
        return {"icp_error": np.linspace(0, 1, n), "icp_iters": np.arange(n),
                "icp_converged": np.arange(n) % 2 == 0,
                "frame_npts": np.full(n, 99), "loop_count": 2}


@pytest.mark.parametrize("fn", ["export_all", "export_snapshot"])
def test_export_copy_writes_the_same_files(tmp_path, rng, fn):
    gkw = dict(grid_dim=64)
    args = ({"extra": {"ate_rmse": 0.5}, "gt": jdataset.generate_trajectory(12)}
            if fn == "export_all" else {})
    getattr(export, fn)(str(tmp_path / "t"),
                        _Engine(np.random.default_rng(1), OccupancyGridConfig(**gkw)),
                        **args)
    getattr(jexport, fn)(str(tmp_path / "j"),
                         _Engine(np.random.default_rng(1), JGridConfig(**gkw)),
                         **args)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    want = {"trajectory.txt", "map.ply", "occupancy.npz", "occupancy.pgm",
            "metrics.jsonl"}
    if fn == "export_all":
        want |= {"trajectory_tum.txt"}
    assert want <= set(names)
    for name in want - {"occupancy.npz"}:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name
    with np.load(tmp_path / "t" / "occupancy.npz") as a, \
            np.load(tmp_path / "j" / "occupancy.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
