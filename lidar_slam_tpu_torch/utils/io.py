"""Dataset I/O: PLY and KITTI-bin point-cloud loading, frame discovery
(jax-free copy of ``lidar_slam_tpu/utils/io.py``, numpy only).

The code is copied unchanged so both packages read and write the same bytes
(``tests/test_torch_io.py`` holds the copy to the original on the same
files); the native reader with readahead prefetching is bound in
``utils/native.py``.

Parity notes:
- ``load_ply`` handles binary_little_endian and ASCII bodies, arbitrary
  property layouts (x/y/z extracted by byte offset), CRLF headers
  (file_utils.cpp:32-61).
- ``load_bin`` reads KITTI x,y,z,intensity float32 quads and drops intensity
  (file_utils.cpp:115-141).
- ``discover_frames`` lists .ply by ``(\\d+).ply`` timestamp and .bin by
  numeric stem, sorted ascending (file_utils.cpp:217-247).
- ``load_scan`` dispatches on the extension (the reference discovers .bin
  files but always parses them as PLY, slam_node.cpp:121).
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

_PLY_TYPE = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1), "int8": ("i1", 1),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2), "short": ("<i2", 2), "int16": ("<i2", 2),
    "uint": ("<u4", 4), "uint32": ("<u4", 4), "int": ("<i4", 4), "int32": ("<i4", 4),
}


def load_ply(path: str) -> np.ndarray:
    """Load x,y,z from a PLY file -> (n, 3) float32 (file_utils.cpp:20-108)."""
    with open(path, "rb") as f:
        num_vertices = 0
        is_binary = False
        props: List[Tuple[str, str]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"PLY header truncated: {path}")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format" and len(tok) > 1:
                is_binary = tok[1].startswith("binary")
            elif tok[0] == "element" and len(tok) > 2 and tok[1] == "vertex":
                num_vertices = int(tok[2])
            elif tok[0] == "property" and len(tok) > 2:
                props.append((tok[2], tok[1]))  # (name, dtype)
            elif tok[0] == "end_header":
                break
        if is_binary:
            fields = [
                (name, _PLY_TYPE.get(dtype, ("<f4", 4))[0]) for name, dtype in props
            ]
            rec = np.dtype(fields)
            data = np.frombuffer(f.read(rec.itemsize * num_vertices), dtype=rec,
                                 count=num_vertices)
            pts = np.stack(
                [data["x"], data["y"], data["z"]], axis=1
            ).astype(np.float32)
        else:
            body = np.loadtxt(f, dtype=np.float64, max_rows=num_vertices, ndmin=2)
            names = [n for n, _ in props]
            ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
            pts = body[:, [ix, iy, iz]].astype(np.float32)
    return pts


def load_bin(path: str) -> np.ndarray:
    """KITTI .bin: x,y,z,intensity float32 quads; intensity dropped
    (file_utils.cpp:115-141)."""
    raw = np.fromfile(path, dtype=np.float32)
    n = len(raw) // 4
    return raw[: n * 4].reshape(n, 4)[:, :3].copy()


def load_scan(path: str) -> np.ndarray:
    """Load by extension — fixes reference quirk #4 (always-PLY parse)."""
    if path.endswith(".bin"):
        return load_bin(path)
    return load_ply(path)


def save_ply(path: str, pts: np.ndarray, intensity: np.ndarray | None = None) -> None:
    """Binary-little-endian PLY writer (mirrors convert_to_ply.cpp:46-60)."""
    n = len(pts)
    has_i = intensity is not None
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        + ("property float intensity\n" if has_i else "")
        + "end_header\n"
    )
    cols = 4 if has_i else 3
    body = np.empty((n, cols), np.float32)
    body[:, :3] = pts
    if has_i:
        body[:, 3] = intensity
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(body.tobytes())


def voxel_downsample_np(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Host voxel-grid centroid downsample in NumPy (same semantics as
    reference file_utils.cpp:148-196; the main path uses the native one)."""
    if voxel <= 0:
        return pts
    keys = np.floor(pts / voxel).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    n = inv.max() + 1 if len(inv) else 0
    sums = np.zeros((n, 3), np.float64)
    np.add.at(sums, inv, pts)
    cnts = np.bincount(inv, minlength=n)
    return (sums / cnts[:, None]).astype(np.float32)


def extract_timestamp(filename: str) -> int:
    """``(\\d+).ply`` -> timestamp, else -1 (file_utils.cpp:203-210)."""
    m = re.search(r"(\d+)\.ply", filename)
    return int(m.group(1)) if m else -1


def discover_frames(data_dir: str) -> List[Tuple[int, str]]:
    """Sorted (timestamp/index, path) list of .ply/.bin frames
    (file_utils.cpp:217-247)."""
    frames: List[Tuple[int, str]] = []
    for name in os.listdir(data_dir):
        path = os.path.join(data_dir, name)
        if name.endswith(".ply"):
            ts = extract_timestamp(name)
            if ts >= 0:
                frames.append((ts, path))
        elif name.endswith(".bin"):
            m = re.search(r"(\d+)\.bin", name)
            if m:
                frames.append((int(m.group(1)), path))
    frames.sort(key=lambda x: x[0])
    return frames


def convert_bin_to_ply(input_path: str, output_path: str) -> int:
    """KITTI .bin -> binary PLY with intensity (tools/convert_to_ply.cpp:14-67).
    Returns the number of points converted."""
    raw = np.fromfile(input_path, dtype=np.float32)
    n = len(raw) // 4
    data = raw[: n * 4].reshape(n, 4)
    save_ply(output_path, data[:, :3], data[:, 3])
    return n


def convert_directory(input_dir: str, output_dir: str) -> int:
    """Directory mode of the converter (convert_to_ply.cpp:69-95)."""
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(input_dir)):
        if name.endswith(".bin"):
            out = os.path.join(output_dir, name[:-4] + ".ply")
            convert_bin_to_ply(os.path.join(input_dir, name), out)
            count += 1
    return count
