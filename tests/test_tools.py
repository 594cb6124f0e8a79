"""Unit coverage for the measurement-artifact tooling: bench_nsweep's
per-row BENCH_DETAILS merge and the perf-table renderer.  These guard the
sweep workflow (bench --sweep / tools/bench_nsweep.py -> tools/perf_table.py)
that produces the recorded perf rows — a schema drift between writer and
renderer has broken it once before (ADVICE r4, perf_table vs the r4 dict
schema)."""

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _load(modname, relpath):
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(ROOT, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(workload="brownian", xi=0.5, n=None, v=1e6):
    r = {
        "workload": workload,
        "xi": xi,
        "grid": [96, 96, 96],
        "rcut": 5.26,
        "engine": "banded",
        "steps_per_sec": v / 1e5,
        "particle_steps_per_sec": v,
        "m_lanczos": 7,
    }
    if n is not None:
        r["n"] = n
    return r


def test_merge_row_inserts_replaces_and_keeps_others(tmp_path):
    nsweep = _load("bench_nsweep", "tools/bench_nsweep.py")
    path = tmp_path / "BENCH_DETAILS.json"

    # fresh file
    nsweep.merge_row(_row(n=300_000), str(path))
    d = json.loads(path.read_text())
    assert len(d["results"]) == 1

    # existing file with a headline row (no 'n') + extra top-level keys:
    # merging an N row must not touch either
    d["chip"] = "NVIDIA H100 80GB HBM3"
    d["results"].append(_row(v=7.45e6))
    path.write_text(json.dumps(d))
    nsweep.merge_row(_row(n=1_000_000, v=5e6), str(path))
    d = json.loads(path.read_text())
    assert d["chip"] == "NVIDIA H100 80GB HBM3"
    assert len(d["results"]) == 3

    # same (workload, xi, n) key replaces, never duplicates
    nsweep.merge_row(_row(n=1_000_000, v=5.5e6), str(path))
    d = json.loads(path.read_text())
    assert len(d["results"]) == 3
    byn = {r.get("n"): r for r in d["results"]}
    assert byn[1_000_000]["particle_steps_per_sec"] == 5.5e6


def test_perf_table_renders_both_schemas(tmp_path):
    rows = [_row(v=7.45e6), _row(n=300_000, v=6.0e6)]
    for payload in (rows, {"chip": "x", "results": rows}):
        p = tmp_path / "details.json"
        p.write_text(json.dumps(payload))
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "perf_table.py"),
             str(p)],
            capture_output=True, text=True, check=True,
        ).stdout
        lines = [ln for ln in out.splitlines() if ln.startswith("|")]
        assert len(lines) == 2 + len(rows)          # header + rule + rows
        assert "| 100,000 |" in lines[2]            # n defaults to headline N
        assert "| 300,000 |" in lines[3]
