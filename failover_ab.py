#!/usr/bin/env python3
"""A/B of ``chip_smoke.py``'s ``[failover]`` phase between this checkout
and another one, say the parent commit unpacked with ``git archive`` into
a gitignored directory, on one GPU:

    python3 failover_ab.py --other _archive/parent [--pairs 2]

Each turn is a fresh process in one checkout that builds that
checkout's kernels and runs its ``failover_phase`` (the master killed at
its 7th task request and restored from its state dir, the launcher with
``--network-check``, nano-350m on an ``ElasticDataset``; every gate of
the phase holds). Turns alternate (other, this; this, other; ...).

Each turn prints the phase's ``{"failover": ...}`` line. The last line
but one gives each side's medians and ranges of the outage, the agent's
ride-through, the master's restore, the node check's total and the
phase's seconds; the last line, the card's name and power limit as
``nvidia-smi`` reports them. Exits 1 if a turn fails.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KEYS = ("outage_s", "agent_ride_through_s", "master_restore_s", "phase_s")

# one turn: run from the checkout under test, which imports its own
# chip_smoke.py and package
TURN = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from dlrover_tpu_torch.ops import _build
os.environ["ELASTIC_JOB_NAME"] = f"foab{os.getpid()}"
cs.CARD["line"] = sys.argv[1]
_build.build()
try:
    cs.failover_phase(cs.slice_config())
finally:
    cs.unlink_segments(os.environ["ELASTIC_JOB_NAME"])
"""


def turn(tree: Path, card: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, card], cwd=str(tree),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith('{"failover"'):
            return json.loads(line)["failover"]
    raise SystemExit(f"{tree}: the phase failed (exit {proc.returncode}):\n"
                     f"{(proc.stdout + proc.stderr)[-4000:]}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", required=True, type=Path)
    parser.add_argument("--pairs", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("failover_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sides = {"this": HERE, "other": args.other.resolve()}
    runs: dict = {"this": [], "other": []}
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        for side in order:
            report = turn(sides[side], card)
            runs[side].append(report)
            print(json.dumps({"side": side, "failover": report}),
                  flush=True)
    summary = {}
    for side, reports in runs.items():
        rows = [dict({k: r[k] for k in KEYS},
                     node_check_total_s=r["node_check"]["total_s"])
                for r in reports]
        summary[side] = {key: {
            "median": statistics.median(row[key] for row in rows),
            "range": [min(row[key] for row in rows),
                      max(row[key] for row in rows)]} for key in rows[0]}
    print(json.dumps({"failover_ab": summary}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
