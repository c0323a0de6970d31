"""Nothing under portbench/ imports JAX, the JAX package or the JAX
package's benchmarks; names are compared whole, since the port's name
begins with the JAX package's."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
HERE = os.path.join(ROOT, "portbench")


def sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_a_forbidden_top_level_name():
    for path in sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_module_reads_the_jax_benchmarks():
    """No string in the harness names the JAX benchmarks' folder."""
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.startswith("benchmarks"), path
                assert "/benchmarks" not in node.value, path


def test_importing_every_module_loads_no_jax():
    mods = ["portbench." + os.path.relpath(p, HERE)[:-3].replace(os.sep, ".")
            for p in sources()
            if "tests" not in p and "metrics" not in p and "run" not in p
            and not p.endswith("__init__.py")]
    code = ("import sys; sys.path[:0] = [%r, %r]\n" % (ROOT, os.path.join(ROOT, "src"))
            + "".join(f"import {m}\n" for m in mods)
            + "from portbench import harness, spec\n"
            + "import json\nb = json.load(open(%r))\n" % os.path.join(ROOT, "BENCHMARK.json")
            + "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            + "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_look_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_refuses_without_enough_cards(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", "sdxl-dit.generate", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
