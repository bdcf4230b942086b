#!/usr/bin/env python3
"""Scan Context retrieval on one NVIDIA GPU: the float64-summed product of
``ops/scan_context.sc_distances`` against the same search with float32 sums,
and the DB-sharded top-k beside the unsharded one.

On a 4,608-frame DB (``chip_smoke.py``'s engine route: its 500 host-voxelized
scans' descriptors in the first rows, the rest empty) it reports, for
``pairs`` alternating pairs (float32, float64, float64, float32, ...), the ms
a call of each form, and for each form whether a DB split over 4 shards
gives the unsharded distances bit for bit (the reason the port sums in
float64). Run from the repository root on a machine with a card:

    python3 tools/bench_retrieval.py [--pairs 5] [--out build/profile/retrieval.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default="build/profile/retrieval.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import scan_context as sc

    dev = torch.device("cuda:0")
    pipeline.pin_f32_matmuls()
    scans, _, _ = chip_smoke.prepare_route()
    db = chip_smoke.scan_context_db(scans, dev)
    norm = torch.sqrt(torch.sum(db * db, dim=(1, 2)))
    q = db[chip_smoke.N_FRAMES - 20]

    def f32_distances(query, d, dn):
        """``sc_distances`` with float32 sums (the form before float64)."""
        S, F = query.shape[-1], d.shape[0]
        dots = torch.matmul(sc._rolled_queries(query), d.reshape(F, -1).T)
        qn = torch.sqrt(torch.sum(query * query))
        n = qn * dn
        best, shift = torch.max(dots / torch.clamp(n, min=1e-30)[None, :], dim=0)
        dist = torch.where(n < 1e-10, torch.ones_like(best), 1.0 - best)
        return dist, shift

    forms = {"float32": f32_distances, "float64": sc.sc_distances}
    out = {"device": torch.cuda.get_device_name(0),
           "power_limit": chip_smoke.nvidia_smi(), "db_rows": int(db.shape[0])}
    for name, fn in forms.items():
        whole, _ = fn(q, db, norm)
        parts = torch.cat([fn(q, db[i:i + db.shape[0] // 4],
                              norm[i:i + db.shape[0] // 4])[0]
                           for i in range(0, db.shape[0], db.shape[0] // 4)])
        torch.cuda.synchronize()
        out[f"{name}/split_equal"] = bool(torch.equal(whole, parts))
        out[f"{name}/split_max_abs_diff"] = float((whole - parts).abs().max())
        out[f"{name}/ms"] = []
    for p in range(args.pairs):
        order = ("float32", "float64") if p % 2 == 0 else ("float64", "float32")
        for name in order:
            out[f"{name}/ms"].append(chip_smoke.time_ms(
                lambda fn=forms[name]: fn(q, db, norm), reps=50))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
