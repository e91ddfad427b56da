"""The serving cell's capacity, found once by a sweep of fixed offered rates
on the card (the cell then offers a fixed share of it; nothing searches at
run time).

    python3 portbench/sweep.py --workload serve_a2_1024 --rates 100,140,180 --seconds 20

The cell has to be an entry of ``BENCHMARK.json``. One server for the
whole sweep; at each rate a fresh client process sends its closed-loop
warm-up, then offers the cell's open loop for ``--seconds``. One JSON line a rate: requests
offered and answered, answered a second, p50/p95/p99 ms, how late the
client ran, and whether a backlog grew (the last tenth of the requests
waited more than twice as long as the first tenth's median, and 50 ms
more).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", default="serve_a2_1024")
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--warmup", type=int, default=64,
                        help="closed-loop requests each client sends before its window")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    kind = harness.traffic(cell["kind"])
    ctx = harness.Context(cell, harness.load_config(cell["config"]), args.seed, args.seconds,
                          False, torch.device("cuda", 0),
                          harness.load_json(harness.HERE / "peaks.json"))
    state = kind.setup(ctx)
    try:
        kind.finish_client(state.pop("client"), args.seconds + 120)  # the warm-up client
        for rate in [float(r) for r in args.rates.split(",")]:
            res = kind.finish_client(kind.start_client(ctx, state, rate, args.seconds, args.warmup),
                                     args.seconds + 180)
            lat = np.minimum(res["latency"], 1e9) * 1e3
            tenth = max(1, len(lat) // 10)
            first, last = np.median(lat[:tenth]), np.median(lat[-tenth:])
            print(json.dumps({
                "rate": rate, "offered": len(lat), "answered": int(res["ok"].sum()),
                "answered_per_s": float(res["ok"].sum() / res["window_s"]),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "late_p95_ms": float(np.percentile(res["late"], 95) * 1e3),
                "first_tenth_ms": float(first), "last_tenth_ms": float(last),
                "backlog_grew": bool(last > 2 * first and last - first > 50.0)}), flush=True)
    finally:
        kind.stop_server(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
