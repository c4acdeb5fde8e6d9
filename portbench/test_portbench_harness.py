"""CPU tests of the harness (`portbench/`): the manifest's names and files,
the import guard, a run of each cell at a tiny scale through the port's
plain paths in a fresh process (whole, with the control in the port's
place, and with the timed path broken underneath), a new cell added by
files alone, and the readers of the per-layer metrics on a made-up trace.
The one test that needs the card is marked `gpu`."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import (devtrace, layers, manifest, rehearse, roofline, run,
                       window)

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = ("lubm63.adhoc",)
FAULTS = ("none", "control", "altered_answer", "half_left_out")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


# --- the manifest -----------------------------------------------------------


def test_manifest_names_units_and_files():
    man = manifest.load_manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert not any(w.startswith("/") or ".." in w for w in man["command"])
    metrics = man["end_to_end"] + man["per_layer"]
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in metrics])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in man["workloads"]] + [
            k for c in man["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
        assert callable(manifest.reader(m["name"]))
    for c in man["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert manifest.generator(cfg["schema"])
        assert set(c["reduced"]) <= set(cfg)
    for w in man["workloads"]:
        cell = manifest.resolve(man, w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert manifest.kind(cell.traffic["kind"]).Loop
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


# --- the import guard ---------------------------------------------------------


@pytest.mark.parametrize("mods,bad", [
    (["repro_torch", "repro_torch.core", "numpy", "torch"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jaxlib.xla_client", "numpy"], ["jaxlib"]),
    (["flax.linen", "jax"], ["flax", "jax"]),
    (["reproduce", "jaxtyping"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(mods, bad):
    assert run.forbidden_modules(mods) == bad


def test_the_command_refuses_without_a_card(tmp_path):
    """No card: no result and a code other than 0, in the checkout and in
    a directory that holds only BENCHMARK.json and the benchmark."""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "portbench", bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    for cwd, env in ((ROOT, _env()), (bare, {**_env(), "PYTHONPATH": ""})):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "lubm63.adhoc", "--seed", "1", "--seconds", "1"],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == "", out.stderr


# --- runs at a tiny scale on the CPU ------------------------------------------


@pytest.fixture(scope="module")
def rehearsals():
    cases = [f"{c}:{f}" for c in CELLS for f in FAULTS]
    out = subprocess.run([sys.executable, "-m", "portbench.rehearse", *cases],
                         cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    return {r["case"]: r for r in lines}


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_loads_no_jax(rehearsals, cell):
    r = rehearsals[f"{cell}:none"]
    tiny = rehearse.tiny_cell(cell)
    want = {m["name"] for m in tiny.end_to_end}
    assert r["correct"] is True and r["forbidden"] == []
    assert set(r["metrics"]) == want
    assert r["attempted"] > 0 and r["failed"] == 0
    # the window holds whole rounds of the query set
    assert r["attempted"] % len(tiny.config[tiny.traffic["queries"]]) == 0
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[:5] == ["case", "correct", "attempted", "failed",
                           "metrics"]
    assert list(r)[-2] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", FAULTS[1:])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_each_fault_come_out_not_correct(rehearsals, cell,
                                                         fault):
    r = rehearsals[f"{cell}:{fault}"]
    assert r["correct"] is False
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with one entry each: the harness finds and runs them unedited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "portbench"
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "lubm63.json").read_text())
    cfg["universities"] = 1
    (bench / "configs" / "lubm1.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "adhoc.json").read_text())
    traffic["caps"] = rehearse.CPU_CAPS
    (bench / "traffic" / "adhoc_cpu.json").write_text(json.dumps(traffic))
    (bench / "layer_metrics" / "rows_per_answer.tiny.py").write_text(
        "def read(ctx):\n"
        "    rs = ctx.window.requests\n"
        "    return sum(len(r.rows) for r in rs) / len(rs)\n")
    man["configs"].append({"name": "lubm1", "source": "LUBM, one university",
                           "file": "portbench/configs/lubm1.json",
                           "reduced": ["universities"], "why": "a test"})
    man["workloads"].append({"name": "lubm1.tiny", "config": "lubm1",
                             "traffic": "adhoc_cpu", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "rows_per_answer.tiny", "unit": "rows",
                             "better": "higher", "source": "program_counter",
                             "layer": "a test", "moves": "qps",
                             "workloads": ["lubm1.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    script = (
        "import json\n"
        "from portbench import layers, manifest, run\n"
        "cell = manifest.resolve(manifest.load_manifest(), 'lubm1.tiny')\n"
        "args = run.parse_args(['--workload', 'lubm1.tiny', '--seed', '5',"
        " '--seconds', '0.3'])\n"
        "res = run.run(args, device='cpu')\n"
        "from portbench.gen import lubm\n"
        "from portbench.window import Window, Request\n"
        "import numpy as np\n"
        "w = Window([Request('q', '', 0.0, 1.0, 'ok', ('?x',),"
        " np.zeros((3, 1)))], 0.0, 1.0)\n"
        "ctx = layers.Context(None, w, None, None, 'cpu')\n"
        "read = manifest.reader(cell.per_layer[-1]['name'])\n"
        "print(json.dumps({'correct': res['correct'], "
        "'per_layer': [m['name'] for m in cell.per_layer], "
        "'value': read(ctx), 'metrics': sorted(res['metrics'])}))\n")
    env = {**_env(), "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["correct"] is True and got["value"] == 3.0
    assert got["per_layer"] == ["rows_per_answer.tiny"]
    assert "qps" in got["metrics"]


# --- the pieces on made-up data ---------------------------------------------


def _trace(ops, t0=0, t1=1_000_000):
    tr = devtrace.DeviceTrace(None)
    tr.ops, tr.t0, tr.t1 = ops, t0, t1
    return tr


def test_busy_time_idle_gaps_and_breakdown():
    ops = [("searchsorted_kernel(long const*)", "kernel", 100_000, 100_000),
           ("void at::native::elementwise", "kernel", 150_000, 100_000),
           ("Memcpy DtoH", "gpu_memcpy", 600_000, 100_000)]
    tr = _trace(ops)
    assert tr.busy_intervals() == [[100_000, 250_000], [600_000, 700_000]]
    assert tr.busy_s() == pytest.approx(250e-6)
    spans = [("execute_local", 0, 120_000), ("copy_out", 250_000, 800_000),
             ("step", 200_000, 1_000_000)]
    b = tr.breakdown(spans)
    assert b["device_ops"][0] == ["searchsorted_kernel(long const*)", 1e-4]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"execute_local": 100e-6, "copy_out": 350e-6, "step": 300e-6})


class _Loop:
    def op_bytes(self, window, torch):
        return {"searchsorted": 3.35e5, "probe_gather": 0}


def _ctx(ops):
    reqs = [window.Request("q", "", 0.0, 0.5, "ok", ("?x",),
                           np.zeros((1, 1))) for _ in range(4)]
    win = window.Window(reqs, 0.0, 1.0)
    return layers.Context(None, win, _trace(ops), _Loop(),
                          "NVIDIA H100 80GB HBM3")


def test_the_per_layer_readers():
    ops = [("searchsorted_kernel(long const*)", "kernel", 0, 200_000),
           ("void at::native::searchsorted_cuda_kernel", "kernel", 300_000,
            100_000),
           ("Memset", "gpu_memset", 500_000, 100_000)]
    ctx = _ctx(ops)
    read = lambda n: manifest.reader(n)(ctx)
    # 3.35e5 bytes at 3.35e12 B/s = 0.1 us, over 200 us of the kernel
    assert read("searchsorted_roofline.adhoc") == pytest.approx(0.05)
    assert read("probe_gather_roofline.adhoc") is None
    assert read("launches_per_query.adhoc") == pytest.approx(2 / 4)
    assert read("cascade_device_ms.adhoc") == pytest.approx(0.3 / 4)
    assert read("device_idle_share.adhoc") == pytest.approx(60.0)
    empty = _ctx([])
    assert all(manifest.reader(m)(empty) is None for m in (
        "searchsorted_roofline.adhoc", "launches_per_query.adhoc",
        "cascade_device_ms.adhoc"))


def test_end_to_end_metrics_count_every_request():
    reqs = [window.Request("q", "", 0.0, 0.010 * (i + 1), "ok")
            for i in range(19)]
    reqs.append(window.Request("q", "", 0.0, None, "failed"))
    win = window.Window(reqs, 0.0, 0.3)
    e = window.end_to_end(win)
    assert e["qps"] == pytest.approx(19 / 0.3)
    assert e["latency_p50_ms"] == pytest.approx(100.0)   # nearest rank
    assert e["latency_p95_ms"] == pytest.approx(190.0)
    assert window.end_to_end(window.Window(reqs[:-1], 0.0, 0.3))[
        "latency_p95_ms"] == pytest.approx(190.0)
    assert win.failed() == 1
    assert window.nearest_rank(list(range(1, 101)), 0.95) == 95


def test_byte_counts_of_the_index_kernels():
    import torch
    keys = torch.arange(0, 64, 2, dtype=torch.int64)          # 32 keys
    q = torch.tensor([3, 3, 9, 70], dtype=torch.int64)
    # 4 queries in and out, 3 distinct x 6-step paths of keys
    assert roofline.searchsorted_bytes(torch, keys, q) == 4 * 16 + 18 * 8
    lo = torch.tensor([0, 10, 5], dtype=torch.int64)
    hi = torch.tensor([8, 10, 6], dtype=torch.int64)
    # live probes 0 and 2, ranges of 4 keys and 0 keys, one filter position
    n = roofline.probe_gather_bytes(torch, keys, lo, hi, None, 2, 0b010)
    assert n == 3 * 16 + 2 * 2 * 6 * 8 + 1 * 1 * 8 + 2 * 8 + 3 * 2 * 9 + 3 * 4


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "lubm63.adhoc",
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
