"""Build, check and time the chamfer nearest-neighbour kernel alone, on one CUDA card.

    python -m fenet_torch.tools.chamfer_dev [--source LABEL=PATH ...] [--case TEXT ...]
        [--slices S] [--target BLOCKS]

Builds ``fenet_torch/csrc/chamfer_nn.cu`` (label ``new``) and every
``--source`` (another version of that file, such as an earlier commit's
unpacked under ``build/``), one ``nvcc`` each, all at once, with the flags of
``fenet_torch.ops._build``, and prints each build's ``ptxas`` lines. A
library with the split entry point (``fenet_chamfer_nn_split``) runs through
the package's wrapper ``chamfer.nn_kernel``, with the slices of M that
``chamfer.nn_slices`` gives at the library's own rows per block and tile
(``--slices`` forces S, ``--target`` sets the blocks target); an earlier
library through its one-pass entry point ``fenet_chamfer_nn``.

For each case (B, N, M) below, or those whose name contains a ``--case``
text, on clouds drawn from a seeded generator on the card:

- checks: dyadic clouds (coordinates k/16: many ties, A points that lie in
  B) bit for bit against ``_nn_ref``, dist and idx, at the library's S and,
  for a split library, also at S = 2 and at one tile a slice; normal clouds
  against ``_nn_ref`` to rtol 1e-5 / atol 1e-6, and bit for bit against
  the first library;
- times: each library's device ms (CUDA events around the replays of a CUDA
  graph that holds 20 launches), the libraries in turns A B ... B A, with
  the SM clock sampled; the package's wrapper's host µs per call
  (``time.perf_counter`` over 1000 calls without a sync) and its
  back-to-back µs by CUDA events around 200 calls (how ``chip_smoke.py``'s
  ``cuda_ms`` times it: host-paced where the host µs is the larger);
  ``torch.cdist(a, b).min(-1)`` and the plain version by CUDA events;
- the issue-slot floor: 9 issued instructions a pair (the cross term's
  FMUL and two FFMA, the FADD, the FFMA of -2ab, the clamp, the compare and
  two selects) at 132 SMs × 128 a clock × 1.98 GHz.

Each case prints one JSON line (also appended to
``chiprun_out/chamfer_dev.jsonl``); a check that fails is reported in its
line (``ok: false``) and makes the exit code 1 after all cases ran.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
import traceback

import torch

from fenet_torch.ops import _build, chamfer
from fenet_torch.tools.devkit import (
    Emitter, build, card, clocks, event_ms, graph_ms, sampler, sources)

ISSUE_SLOTS_PER_S = 132 * 128 * 1.98e9
ISSUES_PER_PAIR = 9
# (name, B, N, M): the eval batches (64, 64, 16 at 1024 points; 64 at 2048),
# the train step's, K2's range, and sizes off every tile.
CASES = (("eval", 64, 1024, 1024), ("eval", 16, 1024, 1024), ("eval", 64, 2048, 2048),
         ("train", 128, 1024, 1024), ("train", 128, 2048, 2048), ("K2", 4, 2048, 16384),
         ("odd", 4, 1000, 1100), ("odd", 1, 1, 1), ("odd", 3, 777, 5))
HOST_CALLS = 1000


def geometry(lib):
    """(rows per block, tile) of a library with the split entry point, else
    None."""
    try:
        return (ctypes.c_int.in_dll(lib, "fenet_chamfer_nn_rows_per_block").value,
                ctypes.c_int.in_dll(lib, "fenet_chamfer_nn_tile").value)
    except ValueError:
        return None


def one_pass(lib):
    """fn(a, b) -> (dist, idx) through an earlier library's one-pass entry
    point."""
    fn = lib.fenet_chamfer_nn
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(a, b):
        bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
        dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
        idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
        _build.check(fn(a.data_ptr(), b.data_ptr(), dist.data_ptr(), idx.data_ptr(), bsz, n, m,
                        torch.cuda.current_stream().cuda_stream), "chamfer_nn")
        return dist, idx

    return call


def split(lib, slices):
    """fn(a, b) -> (dist, idx) through the package's wrapper on ``lib``."""
    def call(a, b):
        _build._loaded["chamfer_nn"] = lib
        return chamfer.nn_kernel(a, b, slices)

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--case", action="append", default=[], metavar="TEXT")
    ap.add_argument("--slices", type=int, default=None, help="force S (capped at the tiles of M)")
    ap.add_argument("--target", type=int, default=None, help="blocks target of nn_slices")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chamfer_dev: needs a CUDA card", file=sys.stderr)
        return 1
    emit = Emitter("chamfer_dev.jsonl")
    device = torch.device("cuda", 0)
    emit({"device": card(), "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    loaded, failed = build(sources(args.source, "chamfer_nn"), "chamfer_nn", emit)
    emit({"build_s": time.perf_counter() - t0, "failed": failed,
          "geometry": {label: geometry(lib) for label, lib in loaded.items()}})
    order = list(loaded) + list(reversed(list(loaded)))

    bad = 0
    t_cases = time.perf_counter()
    for seed, (kind, bsz, n, m) in enumerate(CASES):
        name = f"{kind} B={bsz} N={n} M={m}"
        if args.case and not any(text in name for text in args.case):
            continue
        row = {"case": name, "issue_floor_ms": bsz * n * m * ISSUES_PER_PAIR / ISSUE_SLOTS_PER_S * 1e3}
        try:
            gen = torch.Generator(device).manual_seed(seed)
            dyadic = [torch.randint(-16, 17, (bsz, k, 3), generator=gen, device=device)
                      .float().div_(16) for k in (n, m)]
            normal = [torch.randn(bsz, k, 3, generator=gen, device=device) for k in (n, m)]
            want_dy = chamfer._nn_ref(*dyadic)
            want = chamfer._nn_ref(*normal)
            calls, per, first = {}, {}, None
            for label, lib in loaded.items():
                geo = geometry(lib)
                entry = per[label] = {"ms": []}
                if geo is None:
                    calls[label] = one_pass(lib)
                    checks = {1: calls[label]}
                    entry.update(slices=1, grid=[-(-n // 128), bsz, 1])
                else:
                    rows, tile = geo
                    tiles = -(-m // tile)
                    kw = {} if args.target is None else {"target": args.target}
                    s = args.slices or chamfer.nn_slices(bsz, n, m, rows, tile, **kw)
                    s = min(s, tiles)
                    calls[label] = split(lib, s)
                    checks = {k: split(lib, k) for k in sorted({s, min(2, tiles), tiles})}
                    entry.update(slices=s, grid=[-(-n // rows), bsz, s])
                exact = {}
                for k, fn in checks.items():
                    d, i = fn(*dyadic)
                    exact[k] = bool(torch.equal(d, want_dy[0]) and torch.equal(i, want_dy[1]))
                d, i = calls[label](*normal)
                close = bool(torch.allclose(d, want[0], rtol=1e-5, atol=1e-6))
                if first is None:
                    first = (d, i)
                same = bool(torch.equal(d, first[0]) and torch.equal(i, first[1]))
                entry.update(dyadic_exact_at_slices=exact, normal_close=close,
                             normal_equal_first=same,
                             normal_max_abs_err=float((d - want[0]).abs().max()),
                             ok=all(exact.values()) and close and same)
                bad += not entry["ok"]
            smi = sampler()
            for label in order:
                per[label]["ms"].append(graph_ms(lambda: calls[label](*normal)))
            row["sm_mhz_w"] = clocks(smi)

            _build._loaded["chamfer_nn"] = loaded["new"]
            for _ in range(20):
                chamfer.nn_kernel(*normal)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(HOST_CALLS):
                chamfer.nn_kernel(*normal)
            row["new_host_us_per_call"] = (time.perf_counter() - t) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
            row["new_back_to_back_us"] = event_ms(lambda: chamfer.nn_kernel(*normal), 200) * 1e3
            row["library_ms"] = event_ms(lambda: torch.cdist(*normal).min(-1), 10)
            row["plain_ms"] = event_ms(lambda: chamfer._nn_ref(*normal), 10)
            row["libs"] = per
            emit(row)
        except Exception:  # report the case and go on to the next
            emit({"case": name, "ok": False, "error": traceback.format_exc()})
            bad += 1
        torch.cuda.empty_cache()
    emit({"done": True, "cases_s": time.perf_counter() - t_cases, "failed_checks": bad,
          "failed_builds": failed})
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main())
