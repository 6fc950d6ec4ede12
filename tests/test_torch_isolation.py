"""The port stands alone: no JAX, nothing of the reference package, and
no silent fallback from the card to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_SESSION = r"""
import dataclasses, sys
import repro_torch.config as C
from repro_torch.api import ExperimentSpec, Session
base = C.get_config("vgg9-cifar-small")
C.register(dataclasses.replace(base, arch_id="vgg9-iso", conv_channels=(4, 8),
                               fc_dims=(8,), image_size=8))
res = Session(ExperimentSpec(arch="vgg9-iso", n_clients=2, partition="iid",
                             n_train=40, n_test=10, rounds=2, eval_every=1,
                             policy="fixed(b=4,cut=1)"), device="cpu").run()
assert len(res.train_loss) == 2, res
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
import torch
from repro_torch.device import resolve
if not torch.cuda.is_available():
    try:
        resolve()
    except RuntimeError:
        pass
    else:
        raise AssertionError("resolve() fell back without a card")
print("isolated")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_session_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _SESSION], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def _port_sources():
    return sorted(SRC.glob("repro_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    hits = [m.group(0) for m in bad.finditer(path.read_text())]
    assert not hits, hits


def test_resolve_raises_without_a_card():
    import torch
    from repro_torch.device import resolve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: resolve() returns it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve()
    assert resolve("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_card_or_checkout(tmp_path):
    """Alone in a directory (or without a card) the script prints no
    result and exits non-zero."""
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_port_sources_cover_mesh_and_traffic():
    """The per-source import check above reaches every module of the
    mesh and traffic slices."""
    covered = {str(p.relative_to(SRC)) for p in _port_sources()
               if p.is_relative_to(SRC)}
    for name in ("__init__", "spec", "topology", "sharded", "bank", "launch"):
        assert f"repro_torch/mesh/{name}.py" in covered, name
    for name in ("__init__", "store"):
        assert f"repro_torch/traffic/{name}.py" in covered, name


def test_mesh_session_without_device_raises_without_a_card():
    """``Session(spec_with_mesh)`` asks for the card and raises without
    one: no CPU fallback, and no process group is made first."""
    import torch
    import torch.distributed as dist
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.mesh import MeshSpec

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the session would run on it")
    had_group = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(ExperimentSpec(n_clients=4, mesh=MeshSpec(n_edges=2)))
    assert dist.is_initialized() == had_group
