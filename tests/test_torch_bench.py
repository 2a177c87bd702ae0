"""`python3 -m rpt_tpu_torch.bench` on the CPU, its workloads cut to a tiny
size: it runs its gates, times its samples and prints one JSON line per
workload with the keys of the JAX package's `bench.py`, the ray count as it
counts them."""

import json

import pytest

from rpt_tpu_torch import bench


@pytest.mark.parametrize("workload", ["cornell", "lego_toy"])
def test_bench_prints_a_line_per_workload(workload, capsys, monkeypatch):
    _, _, bounces, shadow, _, _ = bench.WORKLOADS[workload]
    monkeypatch.setitem(bench.WORKLOADS, workload, (16, 12, bounces, shadow, 1, 1))
    assert bench.main(["--device", "cpu", "--workloads", workload]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert {"metric", "value", "unit", "spread", "device", "resolution"} <= set(row)
    assert row["metric"] == f"{workload}_rays_per_sec" and row["unit"] == "rays/s"
    assert row["device"] == "cpu" and row["resolution"] == "16x12" and row["card"] is None
    rays = (bounces + 1) * (1 + shadow) * 16 * 12
    assert len(row["seconds"]) == 3
    median = sorted(row["seconds"])[1]
    assert row["value"] == pytest.approx(rays / median)
    assert row["spread"] == pytest.approx((max(row["seconds"]) - min(row["seconds"])) / median)
    assert row["gates"] == {"kernels": "cpu: plain versions only", "graph_vs_eager": "cpu: both eager, bit_equal"}


def test_bench_refuses_an_unknown_workload(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--workloads", "teapot"])
    assert "unknown workloads ['teapot']" in capsys.readouterr().err
