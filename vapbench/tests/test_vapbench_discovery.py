"""The harness finds a new cell by its name: a workload file dropped into
a copy of the benchmark, and its entry in that copy's BENCHMARK.json, run
with no edit to any code; a name with no file is refused."""

import json
import os
import shutil
import subprocess
import sys

from vapbench.common import HERE, ROOT

CODE = """
import json, time
from vapbench.run import execute
line = execute("vap20-fast-open-8", 2 ** 36 + 5, 3.0, False, "cpu",
               t_proc=time.time())
line.pop("info")
print(json.dumps(line))
"""


def _copy(tmp_path):
    dst = tmp_path / "ckout"
    shutil.copytree(HERE, dst / "vapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return dst


def test_new_workload_file_runs_by_name(tmp_path):
    dst = _copy(tmp_path)
    wl = json.load(open(dst / "vapbench/workloads/vap20-fast-open.json"))
    wl.update(name="vap20-fast-open-8", streams=8)
    wl["audio"].update(clips=4, seconds=8)
    (dst / "vapbench/workloads/vap20-fast-open-8.json").write_text(
        json.dumps(wl))
    bench = json.load(open(dst / "BENCHMARK.json"))
    bench["workloads"].append(
        {"name": "vap20-fast-open-8", "config": "vap_jp_20hz_2500ms",
         "traffic": "fast-open-8", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vap20-fast-open" in m.get("workloads", []):
            m["workloads"].append("vap20-fast-open-8")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", CODE], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] == 8 * 60
    assert set(line["metrics"]) == {"frame_latency_p95_ms",
                                    "frame_latency_p50_ms", "setup_s"}
    assert list(line)[-1] == "limits"


def test_unknown_cell_is_refused(tmp_path):
    dst = _copy(tmp_path)
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{ROOT}")
    out = subprocess.run(
        [sys.executable, "-m", "vapbench.run", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=dst, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_no_card_no_result(tmp_path):
    """Here there is no card: the run exits non-zero and prints no
    result (on the card this test skips its point)."""
    import torch

    if torch.cuda.is_available():
        return
    dst = _copy(tmp_path)
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{ROOT}")
    out = subprocess.run(
        [sys.executable, "-m", "vapbench.run", "--workload",
         "vap20-fast-open", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=dst, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
