"""The port's examples on the CPU, at the sizes of ``tests/test_examples.py``.

``serve_care``'s workload is numpy in both packages, so its table (messages
and mean JCT of every cell) must equal the reference's ``serve_grid`` on the
same cells bit for bit, and the example itself asserts that its
``CareDispatcher`` replay equals the grid.  ``quickstart`` draws with the
port's own generator, so against the reference only invariants hold:
Theorem 2.3's max AQ <= x-1 in every ET row, JSQ's one message a
departure, and fewer messages as x grows.
"""
import dataclasses

import numpy as np

from repro.serve import engine as jeng
from repro_torch.examples import quickstart, serve_care


def test_quickstart_runs_and_holds_theorem_2_3(capsys):
    out = quickstart.main(["--device", "cpu", "--slots", "2000"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "8 cells ran as 5 simulate_grid calls" in "\n".join(lines)
    assert lines[-2].startswith("Next: python -m repro_torch.examples.serve_care")
    assert "few percent of the exact-state communication" in "\n".join(lines[-6:])
    rows = {r["name"]: r for r in out["rows"]}
    assert len(rows) == 8 and out["calls"] == 5
    for r in out["rows"]:
        if r["comm"] == "et":
            assert r["max_aq"] <= r["x"] - 1, r["name"]
        res = r["result"]
        assert res.arrivals - res.departures == int(res.final_q.sum())
    jsq = rows["JSQ (exact state)"]
    assert jsq["messages"] == jsq["result"].departures and jsq["rel_comm"] == 1.0
    assert rows["JSAQ ET-8 + MSR"]["messages"] < rows["JSAQ ET-2 + MSR"]["messages"]
    assert rows["Round Robin"]["messages"] == 0


def test_serve_care_table_equals_the_reference_grid(capsys):
    out = serve_care.main(["--device", "cpu", "--slots", "1000"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("Reading: the ET dispatcher matches")
    assert any(line.startswith("[golden] CareDispatcher replay of ET-4") for line in lines)
    decode = out["decode"]
    assert tuple(decode["tokens"].shape) == (4, 12)
    assert decode["prefill_launches"] == 0 and decode["decode_launches"] == 0  # the CPU
    dispatch = out["dispatch"]
    assert dispatch["calls"] == 7
    cells = [jeng.ServeConfig(**dataclasses.asdict(c)) for c in dispatch["cells"]]
    groups: dict = {}
    for i, cell in enumerate(cells):
        groups.setdefault(cell.static_part(), []).append(i)
    want = {}
    for static, idxs in groups.items():
        for i, row in zip(idxs, jeng.serve_grid([0], static, [cells[i] for i in idxs])):
            want[i] = row[0]
    for i, (name, got) in enumerate(zip(dispatch["names"], dispatch["results"])):
        assert got.messages == want[i].messages, name
        assert got.mean_jct == want[i].mean_jct, name
        assert got.p99_jct == want[i].p99_jct, name
        assert got.msgs_per_completion == want[i].msgs_per_completion, name
        np.testing.assert_array_equal(got.jct_by_rid, want[i].jct_by_rid, err_msg=name)
    replay = dispatch["replay"]
    assert replay["messages"] == want[1].messages
    np.testing.assert_array_equal(replay["jct_by_rid"], want[1].jct_by_rid)


def test_multipod_dryrun_runs_as_a_subprocess():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multipod_dryrun", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--single-pod"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert "  chips:                256" in lines
    assert lines[-1] == "  -> traces cleanly; the sharding is coherent for this mesh."
