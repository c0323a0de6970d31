"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
at their smallest settings, each in this process through its ``main``."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"

CASES = {
    "quickstart": ["--m-base", "8"],
    "serve_llm": ["--requests", "2"],
    "conditional_generation": ["--m-base", "8", "--m-warmup", "2",
                               "--guidance", "split"],
    "highres_seqpar": ["--m-base", "8", "--m-warmup", "2"],
    "serve_diffusion": ["--requests", "2", "--slots", "2", "--m-base", "8",
                        "--m-warmup", "2"],
    "text_to_image": ["--m-base", "4", "--m-warmup", "2"],
    "heterogeneous_stadi": ["--reduced", "--m-base", "8"],
    "train_tiny_diffusion": ["--steps", "3", "--batch", "2"],
}


def _load(name):
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.endswith("_torch")}
    assert ref == set(CASES)
    assert {p.stem for p in EXAMPLES.glob("*_torch.py")} == {
        f"{n}_torch" for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, tmp_path):
    torch.set_num_threads(2)
    argv = CASES[name] + ["--device", "cpu"]
    if name == "train_tiny_diffusion":
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = _load(name).main(argv)
    assert out is not None
    if name == "train_tiny_diffusion":
        assert (tmp_path / "ckpt").is_dir()
        assert out.losses[-1] < out.losses[0]


def test_examples_default_to_the_card():
    """Without --device an example asks for CUDA (and raises without it)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("quickstart").main([])
