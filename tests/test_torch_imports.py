"""Import guard: the port and ``chip_smoke.py`` never import jax or the JAX
package ``repro``. Checked twice: by importing every module of
``repro_torch`` (and ``chip_smoke``) in a fresh interpreter and reading
``sys.modules``, and by scanning their sources."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
        for name in {_modules()!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", len(sys.modules), "BAD", bad)
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


def test_sources_name_no_jax_and_no_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    offenders = {str(p.relative_to(REPO)): m.group(0).strip()
                 for p in SOURCES for m in [pat.search(p.read_text())] if m}
    assert not offenders, offenders
    assert len(SOURCES) > 20


@pytest.mark.parametrize("module", ["repro_torch.serving.diffusion_engine",
                                    "repro_torch.serving.plan_cache"])
def test_serving_modules_are_guarded(module):
    """The serving slice's modules are among those the guards above import
    and scan, and name the reference module they port."""
    assert module in _modules()
    path = REPO / "src" / (module.replace(".", "/") + ".py")
    assert "repro.serving." + module.rsplit(".", 1)[1] in path.read_text()


def test_text_encoder_is_guarded():
    """The prompt slice's new module is among those the guards above import
    and scan, names the reference module it ports, and holds no jax."""
    module = "repro_torch.models.text_encoder"
    assert module in _modules()
    text = (PORT / "models" / "text_encoder.py").read_text()
    assert "repro.models.text_encoder" in text
    assert "jax" not in text.replace("jax.random", "")
