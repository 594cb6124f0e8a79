"""N-scaling points for BENCH_DETAILS (VERDICT r4 stretch 8): the headline
bench config at N=300k (and optionally 1M, memory permitting) so the
O(N log N) claim is a measured curve.

Each completed point is merged into BENCH_DETAILS.json immediately (keyed
by (workload, xi, n), same scheme bench.py uses), so an OOM at a larger N
cannot lose the smaller points.

Run alone (one process per card):
    python tools/bench_nsweep.py [--ns 300000 1000000] [--steps 200]
"""

import argparse
import json
import os
import sys


def merge_row(row, path):
    """Insert/replace one result row in BENCH_DETAILS.json (bench.py keys
    rows by (workload, xi, n); headline rows carry no 'n' so they never
    collide with these)."""
    try:
        with open(path) as f:
            details = json.load(f)
    except (OSError, ValueError):
        details = {"results": []}
    key = (row.get("workload"), row.get("xi"), row.get("n"))
    details["results"] = [row] + [
        r for r in details.get("results", [])
        if (r.get("workload"), r.get("xi"), r.get("n")) != key
    ]
    with open(path, "w") as f:
        json.dump(details, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", type=int, nargs="+", default=[300_000])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=100)
    args = ap.parse_args()

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    import bench

    rows = []
    for n in args.ns:
        try:
            r = bench.run_bench(n=n, has_forces=False, n_steps=args.steps,
                                chunk=args.chunk)
        except Exception as e:  # noqa: BLE001 — record and keep earlier Ns
            print(f"# N={n} FAILED: {type(e).__name__}: {str(e)[:300]}",
                  file=sys.stderr, flush=True)
            continue
        r["n"] = n
        print(json.dumps(r), flush=True)
        merge_row(r, os.path.join(root, "BENCH_DETAILS.json"))
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
