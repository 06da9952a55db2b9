"""Every examples/torch/ script runs green on the CPU: each asserts its own
analytic answer, so executing it is the test. The scripts solve on the GPU
by default; ``CONICIP_TORCH_DEVICE=cpu`` sends them to the CPU."""

import os
import pathlib
import re
import runpy
import subprocess
import sys

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


def test_parallel_example_spawns_its_cpu_world():
    # --cpu: leg 2 starts two gloo ranks of its own; a hang fails here
    root = pathlib.Path(__file__).parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "torch" / "parallel.py"),
         "--cpu"], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "rank 1 of 2: mesh-sharded batch of 4: all Optimal" in proc.stdout
    assert "checkpoint/resume" in proc.stdout
