"""The command's refusals and its imports: no result without a card or
without the program, and nothing it loads is JAX or the JAX package."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN = ["simbench/run.py", "--workload", "vgg16-hasfl-n20", "--seed",
       "3000000001", "--seconds", "1", "--trace", "0"]


def _run(cwd, args=RUN):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")


def test_refuses_without_a_card(no_card):
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_refuses_an_unknown_workload():
    p = _run(ROOT, ["simbench/run.py", "--workload", "nope", "--seed", "1",
                    "--seconds", "1"])
    assert p.returncode != 0 and p.stdout == ""


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import simbench.run, simbench.harness, simbench.control, simbench.tracing
from simbench.harness import reader
from simbench.cell import load_benchmark
bench = load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    reader(m["name"])
import repro_torch.api, repro_torch.core.sfl, repro_torch.kernels.ops
print(json.dumps(sorted(sys.modules)))
"""


def test_imports_nothing_of_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert p.returncode == 0, p.stderr
    loaded = json.loads(p.stdout.splitlines()[-1])
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN] == []
    assert "repro_torch" in loaded


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from simbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.forbidden_modules()
