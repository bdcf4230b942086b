"""A benchmark cell, found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), the chips it needs, why it exists and the
limits of its output check. Adding a cell, a configuration or a mix is
adding such a file; nothing here names one."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from .traffic.generate import TRAFFIC_DIR, Traffic, load_traffic

BENCH_DIR = Path(__file__).resolve().parent
WORKLOAD_DIR = BENCH_DIR / "workloads"
CONFIG_DIR = BENCH_DIR / "configs"


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file, as written
    traffic: Traffic
    chips: int
    why: str
    limits: dict          # number compared (or its items') -> its limit

    def slam_config(self):
        """The port's ``SlamConfig`` that the file states, field by field."""
        from lidar_slam_tpu_torch import config as C

        return slam_config_from_dict(self.config["slam_config"], C)


def slam_config_from_dict(d: dict, C):
    """``SlamConfig`` from its nested ``dataclasses.asdict`` form; a key the
    port's dataclasses lack is an error, a field left out keeps its
    default."""
    nested = {"icp": C.ICPConfig, "sc": C.ScanContextConfig,
              "lc": C.LoopClosureConfig, "pg": C.PoseGraphConfig,
              "grid": C.OccupancyGridConfig}
    kw = {}
    for k, v in d.items():
        kw[k] = nested[k](**v) if k in nested else v
    names = {f.name for f in dataclasses.fields(C.SlamConfig)}
    extra = set(kw) - names
    if extra:
        raise ValueError(f"SlamConfig has no fields {sorted(extra)}")
    return C.SlamConfig(**kw)


def load_cell(name: str, workload_dir: Path = WORKLOAD_DIR,
              config_dir: Path = CONFIG_DIR,
              traffic_dir: Path = TRAFFIC_DIR) -> Cell:
    path = Path(workload_dir) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path}")
    w = json.loads(path.read_text())
    cfg = json.loads((Path(config_dir) / f"{w['config']}.json").read_text())
    return Cell(name=name, config_name=w["config"], config=cfg,
                traffic=load_traffic(w["traffic"], traffic_dir),
                chips=int(w["chips"]), why=w["why"],
                limits=dict(w.get("limits", {})))
