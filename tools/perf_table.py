"""Render BENCH_DETAILS.json as a markdown perf table (ROADMAP item 9).

Rows come from tools/bench_nsweep.py / tools/resweep_point.py, which merge
measured points into BENCH_DETAILS.json; then
python tools/perf_table.py >> notes.md.  Each sweep point is a fresh
compile, so the sweep is run on demand after any cost-structure change,
not per-commit.
"""

import json
import sys


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "BENCH_DETAILS.json"
    with open(path) as f:
        data = json.load(f)
    # r4 schema: {chip, north_star_chip, results: [...]}; pre-r4: bare list.
    rows = data.get("results", data) if isinstance(data, dict) else data
    print("| workload | N | ξ | grid | rcut | engine | m | p-steps/s "
          "| vs 1e7 |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        g = "×".join(str(x) for x in r["grid"])
        v = r["particle_steps_per_sec"]
        n = r.get("n", 100_000)       # headline rows predate the n field
        print(
            f"| {r['workload']} | {n:,} | {r['xi']} | {g} | {r['rcut']:.2f} "
            f"| {r['engine']} | {r.get('m_lanczos', '—')} "
            f"| {v:,.0f} | {v / 1e7:.3f} |"
        )


if __name__ == "__main__":
    main()
