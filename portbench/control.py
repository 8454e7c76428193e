"""The control of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, one parse pass
fewer in every dynamic block (the step that would tempt a later
change), read by the same comparison as a run, at the cell's own sizes.

    python3 -m portbench.control --workload <name> --seeds 1 2 3

For each seed it makes the cell's inputs, draws the windows a run's
check draws (every input counted as sent), plans them with the sound
reference and with the control, and prints ``ref_mismatch``: how many
of the control's windows the sound reference does not find in the
control's stream. The control's other windows are not written: no
other number of the check reads them. Needs no card; the benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, gen, spec  # noqa: E402
from portbench.reference import blocks, encode  # noqa: E402


def control_reading(workload: str, seed: int, workers: int, root: Path = spec.ROOT) -> dict:
    c = spec.cell(spec.load(root), workload, root)
    cfg = c["config_data"]
    mbs = int(cfg["max_block_size"])
    inputs, order = gen.make(json.loads(c["traffic_file"].read_text()), seed)
    pairs = check.sample_windows(inputs, order, mbs, int(cfg["check"]["ref_windows"]), seed)
    t0 = time.perf_counter()
    sound = check.reference_windows(inputs, pairs, mbs, workers)
    weak = check.reference_windows(inputs, pairs, mbs, workers, passes=blocks.CONVERGENCE_PASSES - 1)
    mismatch = 0
    for (_, k), s, w in zip(pairs, sound, weak):
        bits, end = encode.splice_window(*w[:4], 0, w[4])
        stream = b"\x1f\x8b\x08\0\0\0\0\0\x02\xff" + bits.to_bytes((end + 7) // 8 or 1, "little")
        mismatch += not check.window_found(stream, k, s)
    return {"workload": workload, "seed": seed, "windows": len(pairs), "ref_mismatch": mismatch,
            "limit": check.LIMITS["ref_mismatch"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of correct, at a cell's sizes")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_reading(args.workload, seed, args.workers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
