"""Every examples/torch/ script runs green on the CPU: each asserts its own
analytic answer, so executing it is the test. The scripts solve on the GPU
by default; ``CONICIP_TORCH_DEVICE=cpu`` sends them to the CPU."""

import pathlib
import re
import runpy

import pytest

EXAMPLES = sorted(
    (pathlib.Path(__file__).parent.parent / "examples" / "torch").glob("*.py")
)


def test_the_examples_are_all_there():
    assert [p.name for p in EXAMPLES] == [
        "custom_kkt.py", "lp.py", "parallel.py", "qp.py", "sdp.py", "socp.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_torch_example_runs(path, capsys, monkeypatch):
    monkeypatch.setenv("CONICIP_TORCH_DEVICE", "cpu")
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert "ok" in out


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_torch_example_defaults_to_the_card_and_imports_no_jax(path):
    code = path.read_text()
    assert 'os.environ.get("CONICIP_TORCH_DEVICE", "cuda")' in code
    assert not re.search(r"^\s*(import|from)\s+(jax|conicip_tpu)\b", code,
                         flags=re.M)
