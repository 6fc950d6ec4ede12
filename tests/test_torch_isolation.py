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
    for name in ("__init__", "store", "population", "events", "plane"):
        assert f"repro_torch/traffic/{name}.py" in covered, name


def test_port_sources_cover_the_dynamic_edge_slice():
    """The per-source import check reaches every module of the dynamic
    edge: scenarios, snapshots, the metric logger and the launcher."""
    covered = {str(p.relative_to(SRC)) for p in _port_sources()
               if p.is_relative_to(SRC)}
    for name in ("__init__", "traces", "presets", "controller"):
        assert f"repro_torch/scenarios/{name}.py" in covered, name
    for name in ("__init__", "checkpoint", "metrics"):
        assert f"repro_torch/training/{name}.py" in covered, name
    assert "repro_torch/launch/train.py" in covered


_DYNAMIC = r"""
import dataclasses, sys, tempfile
import repro_torch.config as C
from repro_torch.api import ExperimentSpec, Session, TrafficSpec
from repro_torch.launch import train
base = C.get_config("vgg9-cifar-small")
C.register(dataclasses.replace(base, arch_id="vgg9-iso", conv_channels=(4, 8),
                               fc_dims=(8,), image_size=8))
d = tempfile.mkdtemp()
spec = ExperimentSpec(arch="vgg9-iso", n_clients=2, partition="iid",
                      n_train=40, n_test=10, rounds=2, eval_every=1,
                      policy="fixed(b=4,cut=1)", scenario="churn-heavy",
                      fault_mode="deadline", checkpoint_every=1,
                      checkpoint_dir=d)
Session(spec, device="cpu").run()
res = Session.resume(spec, step=1, device="cpu").run()
assert len(res.train_loss) == 2, res
res = Session(spec.replace(scenario=None, fault_mode="soft",
                           checkpoint_every=0, checkpoint_dir=None,
                           traffic=TrafficSpec(arrival_rate=50.0,
                                               mean_dwell=0.05,
                                               shard_size=8)),
              device="cpu").run()
assert len(res.train_loss) == 2, res
train.main(["--arch", "vgg9-iso", "--clients", "2", "--rounds", "2",
            "--eval-every", "1", "--n-train", "40", "--n-test", "10",
            "--scenario", "straggler-bursts", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("isolated")
"""


def test_port_dynamic_edge_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _DYNAMIC], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_port_sources_cover_the_serving_slice():
    """The per-source import check reaches every module of the token-model
    serving path: the launcher, the models (MoE, mamba, enc-dec and VLM
    included), every token config and the three kernels."""
    covered = {str(p.relative_to(SRC)) for p in _port_sources()
               if p.is_relative_to(SRC)}
    for name in ("__init__", "serve"):
        assert f"repro_torch/launch/{name}.py" in covered, name
    for name in ("layers", "attention", "transformer", "ssm", "factory",
                 "moe", "mamba"):
        assert f"repro_torch/models/{name}.py" in covered, name
    for name in ("flash_attention", "rmsnorm", "mlstm_scan", "ops", "ref"):
        assert f"repro_torch/kernels/{name}.py" in covered, name
    for name in ("qwen3_1_7b", "smollm_135m", "xlstm_350m", "glm4_9b",
                 "phi3_mini_3_8b", "dbrx_132b", "llama4_maverick_400b_a17b",
                 "jamba_v0_1_52b", "whisper_medium", "internvl2_1b",
                 "input_shapes"):
        assert f"repro_torch/configs/{name}.py" in covered, name


_SERVE = r"""
import sys
import numpy as np
import torch
from repro_torch.config import get_config, reduced
from repro_torch.launch.serve import serve
from repro_torch.models import build_model
for arch in ("qwen3-1.7b", "xlstm-350m", "dbrx-132b", "jamba-v0.1-52b",
             "whisper-medium", "internvl2-1b"):
    cfg = reduced(get_config(arch))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    res = serve(cfg, params, toks, 3, device="cpu")
    assert res.tokens.shape == (2, 4), res.tokens.shape
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("isolated")
"""


def test_port_serve_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _SERVE], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_serve_cli_without_device_raises_without_a_card():
    import torch
    from repro_torch.launch import serve as SV

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        SV.main(["--batch", "1", "--prompt-len", "4", "--gen", "1"])


@pytest.mark.parametrize("case", ["window", "wrapped", "positions-differ"])
def test_card_decode_attention_raises_on_unsupported_caches(case,
                                                            monkeypatch):
    """On the card, decode attention raises for no cache: a windowed cache,
    a wrapped ring and sequences at their own positions all reach the
    stored-position decode kernel, with the positions handed over as
    tensors (nothing is read back to the host) and no plain fallback.  The
    card is faked: the dispatch's device check says "card" for CPU
    tensors, and the kernel itself is replaced by a recorder."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A

    monkeypatch.setattr(ops, "_on_card", lambda t: True)

    def trap(*a, **k):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(FA, "flash_decode_plain", trap)
    seen = []
    monkeypatch.setattr(FA, "flash_decode_kernel",
                        lambda *a, **k: seen.append((a, k)) or "kernel")
    q = torch.zeros((2, 1, 4, 32))
    kc = torch.zeros((2, 8, 2, 32))
    k_pos, cur, window = {
        "window": (torch.arange(8).repeat(2, 1), torch.tensor([5, 5]), 4),
        "wrapped": (torch.tensor([[8, 9, 2, 3, 4, 5, 6, 7]] * 2),
                    torch.tensor([9, 9]), 0),
        "positions-differ": (torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1],
                                           [0, 1, 2, 3, 4, 5, 6, -1]]),
                             torch.tensor([3, 6]), 0)}[case]
    assert A.decode_attention(q, kc, kc, k_pos, cur,
                              window=window) == "kernel"
    (args, kw), = seen
    assert args[3] is k_pos and args[4] is cur and kw == {"window": window}


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


def test_port_sources_cover_the_training_slice():
    """The per-source import check reaches every module of the token
    training paths: the SPMD step and the simulator's token cells."""
    covered = {str(p.relative_to(SRC)) for p in _port_sources()
               if p.is_relative_to(SRC)}
    for name in ("training/optim", "data/synthetic", "data/pipeline",
                 "core/profiles", "core/split", "core/sfl", "launch/train",
                 "models/factory", "models/transformer", "convert",
                 "kernels/flash_attention", "kernels/rmsnorm",
                 "kernels/clip_sgd", "kernels/ops"):
        assert f"repro_torch/{name}.py" in covered, name
    assert (SRC / "repro_torch/csrc/flash_attention_bwd.cu").exists()


_TRAIN = r"""
import dataclasses, sys
import repro_torch.config as C
from repro_torch.api import ExperimentSpec, Session
from repro_torch.launch import train
C.register(dataclasses.replace(C.get_config("smollm-tiny"),
                               arch_id="smollm-iso", dtype="float32"))
res = Session(ExperimentSpec(arch="smollm-iso", n_clients=2, partition="iid",
                             n_train=32, n_test=4, seq_len=8, rounds=2,
                             eval_every=1, policy="fixed(b=4,cut=1)"),
              device="cpu").run()
assert len(res.test_loss) == 2, res
rows = train.main(["--mode", "spmd", "--device", "cpu", "--steps", "2",
                   "--seq", "8", "--layers", "2", "--d-model", "64",
                   "--clients", "2", "--batch", "2", "--eval-every", "0"])
assert len(rows) == 2, rows
rows = train.main(["--mode", "spmd", "--device", "cpu", "--arch",
                   "dbrx-132b", "--steps", "1", "--seq", "8", "--layers", "2",
                   "--d-model", "64", "--clients", "2", "--batch", "2",
                   "--eval-every", "0"])
assert len(rows) == 1, rows
import torch
from repro_torch.core.sfl import make_hasfl_train_step
from repro_torch.models import build_model
cfg = C.reduced(C.get_config("whisper-medium"))
init_state, step = make_hasfl_train_step(
    build_model(cfg), n_clients=2, cut_reps=1, agg_interval=2,
    optimizer_name="sgd", lr=1e-2)
state = init_state(torch.Generator().manual_seed(0), "cpu")
batch = {"tokens": torch.zeros((2, 2, 8), dtype=torch.long),
         "labels": torch.ones((2, 2, 8), dtype=torch.long),
         "frame_embeddings": torch.randn(
             (2, 2, cfg.encoder_seq, cfg.d_model),
             generator=torch.Generator().manual_seed(1))}
state, m = step(state, batch)
assert bool(torch.isfinite(m["loss"])), m
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("isolated")
"""


def test_port_token_training_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _TRAIN], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_spmd_cli_without_device_raises_without_a_card():
    import torch
    from repro_torch.launch import train as TR

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the launcher would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.main(["--mode", "spmd", "--steps", "1", "--seq", "8",
                 "--layers", "2", "--d-model", "64", "--clients", "2",
                 "--batch", "2"])
