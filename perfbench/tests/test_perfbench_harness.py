"""The harness resolves cells by name, runs one on the CPU through the
window's own call, and prints the contract's last line."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import harness, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_from_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert {"snapshots", "sigma", "camera", "warmup_steps"} <= set(cell.mix)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(cell.bench_dir, m["name"]))


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"step_ms", "step_p95_ms", "setup_s"} == set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(m["moves"] == "step_ms" for m in BENCH["per_layer"]) and layers
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(c["reduced"])


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_cpu_run_gives_the_last_lines_keys(tiny_root, trace):
    cell = [w for w in BENCH["workloads"] if w["traffic"] == "displaced_ring"][0]
    r = harness.run(cell["name"], 2**31 + 11, 1.0, trace, root=tiny_root,
                    backend="cpu")
    assert list(r) == (["correct", "attempted", "failed", "metrics", "device"]
                       + (["breakdown"] if trace else []) + ["check"])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert set(r["check"]) == {"off_px_share", "mean_level_diff"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert {"frontend.ms", "accel.ms", "kernel.ms"} <= set(r["metrics"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"step_ms", "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_adding_a_cell_takes_new_files_and_entries_only(tiny_root):
    """A new configuration, traffic mix and per-layer metric: three new
    files and new entries in BENCHMARK.json, and the harness runs the cell
    and reports the metric."""
    bench_dir = tiny_root / "perfbench"
    config = json.loads((bench_dir / "configs" / "hea32k_noao.json").read_text())
    config["name"] = "newcfg"
    (bench_dir / "configs" / "newcfg.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "newmix.json").write_text(json.dumps(
        {"snapshots": 2, "sigma": 0.2, "camera": {"kind": "turntable",
                                                  "count": 3, "step_deg": 5.0},
         "warmup_steps": 1}))
    (bench_dir / "metrics" / "steps.count.py").write_text(
        "def read(records):\n    return float(len(records['timings']))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "newcfg", "source": "x", "reduced": [],
                             "file": "perfbench/configs/newcfg.json", "why": "x"})
    bench["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                               "traffic": "newmix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps.count", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "front end", "moves": "step_ms",
                               "workloads": ["newcfg.newmix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("newcfg.newmix", 5, 0.5, True, root=tiny_root, backend="cpu")
    assert r["correct"] and r["metrics"]["steps.count"]["value"] >= 1


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mdapy_tpu_torch_fake", object())
    assert "mdapy_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mdapy_tpu.render", object())
    assert harness.forbidden_modules() == ["mdapy_tpu"]


def test_a_cpu_run_and_the_reference_load_no_jax(tiny_root):
    """In a fresh process: a run (the program included) and, alone, the
    reference, which loads nothing of the program either."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import perfbench.reference.tachyon\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'mdapy_tpu', 'mdapy_tpu_torch'}, top\n"
        "from perfbench import harness\n"
        f"r = harness.run({CELLS[0]!r}, 3, 0.5, False, root={str(tiny_root)!r}, backend='cpu')\n"
        "assert 'mdapy_tpu_torch' in sys.modules\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 2 and out.stdout == ""


def test_a_run_fails_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone: the
    run stops before any result (here on the CPU, past the look for a
    card)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "from perfbench import harness\n"
            f"harness.run({CELLS[0]!r}, 1, 1.0, False, backend='cpu')\n"
            "print('result')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and "mdapy_tpu_torch" in out.stderr
    assert out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_on_the_card(card, name):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          name, "--seed", "424242", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r


def test_the_trace_reduction(tmp_path):
    """Busy time is the union of the device's intervals; an idle gap goes
    to the sampled host lines in proportion, or to the innermost host
    operation at its midpoint when no sample falls in it."""
    from perfbench import devtrace

    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1050.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1400.0, "dur": 50.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 2000.0, "dur": 10.0},
          {"ph": "X", "cat": "user_annotation", "name": devtrace.MARK, "ts": 900.0, "dur": 0.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 1500.0, "dur": 600.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 1600.0, "dur": 300.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # the mark at perf_counter 10.0 s is the trace's 900 us
    samples = [(10.0 + (1200 - 900) * 1e-6, "a.py:1 f"),
               (10.0 + (1300 - 900) * 1e-6, "a.py:1 f"),
               (10.0 + (1350 - 900) * 1e-6, "b.py:2 g")]
    r = devtrace.reduce(path, samples, 10.0)
    assert abs(r["busy_s"] - (150 + 50 + 10) * 1e-6) < 1e-12
    assert r["device_ops"][0][0] == "k1" and abs(r["device_ops"][0][1] - 110e-6) < 1e-12
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["a.py:1 f"] - 250e-6 * 2 / 3) < 1e-12
    assert abs(gaps["b.py:2 g"] - 250e-6 / 3) < 1e-12
    assert abs(gaps["aten::inner"] - 550e-6) < 1e-12


def test_the_host_sampler_names_the_line():
    import time

    from perfbench import devtrace

    with devtrace.HostSampler(0.001) as s:
        t = time.perf_counter()
        while time.perf_counter() - t < 0.05:
            pass
    assert s.samples and any("test_the_host_sampler_names_the_line" in w
                             for _, w in s.samples)
