"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--half-seeds 1,2,3] [--tf32-seeds 1,2,3] [--seconds 2] \
        [--out FILE]

For each seed, in one process: the cell's set-up and a short window
through the program, then the compared numbers of the program against the
reference (the lower reading); on the control seeds, the same numbers of
the control, the reference computed in the cell's ``control`` precision and
put in the program's place (the upper reading); on the half seeds (train
cells), of the reference with half of each batch left out (a fault); on
the TF32 seeds (train cells), of the program itself with the card's TF32
switches turned on where its trainer turns them off. One JSON line a
reading, to standard output and to ``--out``. Cells of ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, required=True)
    parser.add_argument("--control-seeds", type=_ints, default=[])
    parser.add_argument("--half-seeds", type=_ints, default=[])
    parser.add_argument("--tf32-seeds", type=_ints, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.reference.precision import Operands

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    kind = harness.traffic(cell["kind"])
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    runs = [(seed, False) for seed in sorted(set(args.seeds) | set(args.control_seeds)
                                             | set(args.half_seeds))]
    for seed, tf32 in runs + [(seed, True) for seed in args.tf32_seeds]:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, harness.load_config(cell["config"]), seed, args.seconds,
                              False, device, harness.load_json(harness.HERE / "peaks.json"))
        with _tf32_trainer(tf32):
            state = kind.setup(ctx)
            win = kind.window(ctx, state)
        got = kind.program_outputs(ctx, state)
        t_ref = time.perf_counter()
        want = kind.reference_outputs(ctx, state)
        t_ref = time.perf_counter() - t_ref
        if tf32:
            readings = [("program_tf32", got)]
        else:
            readings = [("program", got)] if seed in args.seeds else []
        if seed in args.control_seeds and not tf32:
            readings.append(("control", kind.reference_outputs(
                ctx, state, Operands(cell["params"]["control"]))))
        if seed in args.half_seeds and not tf32:
            readings.append(("half_batch", kind.reference_outputs(ctx, state, half=True)))
        for who, outputs in readings:
            emit({"workload": args.workload, "seed": seed, "who": who,
                  "checks": {c.name: c.value for c in kind.compare(ctx, outputs, want)},
                  "work": win.work, "window_s": win.seconds})
        emit({"workload": args.workload, "seed": seed, "who": "timing",
              "reference_s": t_ref, "total_s": time.perf_counter() - t0})
        del state, got, want, readings
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


@contextlib.contextmanager
def _tf32_trainer(on: bool):
    """While ``on``, the trainer turns the card's TF32 switches on where it
    would turn them off; they are turned off again after."""
    if not on:
        yield
        return
    import torch

    from fenet_torch.train import trainer

    def tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    full_fp32 = trainer.full_fp32
    trainer.full_fp32 = tf32
    try:
        yield
    finally:
        trainer.full_fp32 = full_fp32
        full_fp32()


if __name__ == "__main__":
    sys.exit(main())
