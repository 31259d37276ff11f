"""Nothing the benchmark runs imports JAX or the JAX package, compared by
top-level module name as a whole word (`vap_realtime_tpu_torch` starts
with `vap_realtime_tpu` and is the port); the reference imports nothing
of the port either."""

import ast
import json
import os

from vapbench.common import FORBIDDEN, HERE


def _py_files(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_jax_anywhere():
    bad = {}
    for path in _py_files(HERE):
        hit = _imported(path) & set(FORBIDDEN)
        if hit:
            bad[os.path.relpath(path, HERE)] = sorted(hit)
    assert not bad, bad


def test_modules_named_in_data_files_are_the_port():
    kmap = json.load(open(os.path.join(HERE, "kernel_layers.json")))
    targets = [t for ts in kmap["spans"].values() for t in ts]
    targets += list(kmap["counters"].values())
    for t in targets:
        top = t.split(":")[0].split(".")[0]
        assert top == "vap_realtime_tpu_torch", t
        assert top not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for path in _py_files(ref):
        names = _imported(path)
        assert "vap_realtime_tpu_torch" not in names, path
        assert not names & set(FORBIDDEN), path
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "numpy", "torch", "vapbench"}, (path, names)


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom vap_realtime_tpu.ops "
                 "import basic\nimport vap_realtime_tpu_torch\n")
    names = _imported(str(p))
    assert names & set(FORBIDDEN) == {"jax", "vap_realtime_tpu"}


def test_a_run_loads_no_jax():
    """The modules a run imports, in a fresh interpreter, leave no
    forbidden top-level name in sys.modules."""
    import subprocess
    import sys

    code = ("import vapbench.run, vapbench.serving, vapbench.knee, "
            "vapbench.trace, vapbench.reference.train\n"
            "from vapbench.run import driver\n"
            "[driver(k) for k in ('open', 'closed', 'train')]\n"
            "import vap_realtime_tpu_torch.runtime.arena\n"
            "import vap_realtime_tpu_torch.train.trainer\n"
            "from vapbench.common import forbidden_loaded\n"
            "print(forbidden_loaded())\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_kernel_map_matches_the_kernels_the_sources_declare():
    """`kernel_layers.json`'s patterns name K7's, K5's and K2's kernels as
    `csrc/*.cu` declares them (a renamed kernel would drop out of its
    layer silently)."""
    import re

    kmap = json.load(open(os.path.join(HERE, "kernel_layers.json")))
    pats = [(re.compile(p), layer) for p, layer in kmap["kernels"]]
    csrc = os.path.join(os.path.dirname(HERE), "vap_realtime_tpu_torch",
                        "csrc")
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(")

    def kernels(src):
        return decl.findall(open(os.path.join(csrc, src)).read())

    want = {"conv_stack_fused.cu": "encoder", "lstm_scan.cu": "encoder",
            "attend_pair.cu": "attend"}
    for src, layer in want.items():
        names = kernels(src)
        assert names, src
        for n in names:
            hits = [lay for rx, lay in pats if rx.search(f"void {n}<x>(y)")]
            assert hits and hits[0] == layer, (src, n, hits)
