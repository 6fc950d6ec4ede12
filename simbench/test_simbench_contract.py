"""A configuration brings its own plain reference: a new architecture's
configuration, reference module, traffic and limits, written as new files
alone, run through the harness to a correct result on the CPU; a model key
the reference does not read, a configuration without a reference and a
reference file that is missing are refused by name; a module's own
initialisation of a leaf takes no draw."""
import json
import textwrap

import pytest

from simbench import cell as C
from simbench.harness import run_cell
from simbench.reference import contract
from simbench.test_simbench_reference import _register

NAME = "tiny-window-f32"
MODULE = '''
    """A dense decoder over a frozen type of its own that reads one key
    more than `decoder.py`: ``sliding_window`` (0, full attention, the only
    window it runs).  Every other name is the decoder's contract."""
    import dataclasses

    from simbench.reference import decoder
    from simbench.reference.contract import frozen_arch
    from simbench.reference.decoder import *  # noqa: F401,F403

    READS = decoder.READS + ("sliding_window",)


    @dataclasses.dataclass(frozen=True)
    class Arch:
        arch_id: str
        family: str
        n_layers: int
        d_model: int
        n_heads: int
        n_kv_heads: int
        d_ff: int
        vocab_size: int
        head_dim: int
        tie_embeddings: bool
        rope_theta: float
        norm_eps: float
        dtype: str
        sliding_window: int

        @property
        def resolved_head_dim(self) -> int:
            return self.head_dim or self.d_model // self.n_heads


    def make_arch(model):
        arch = frozen_arch(Arch, model, READS, __file__)
        if arch.sliding_window:
            raise ValueError("windowed.py runs full attention only")
        return arch
'''
MODEL = {"arch_id": NAME, "family": "dense", "n_layers": 2, "d_model": 64,
         "n_heads": 2, "n_kv_heads": 1, "d_ff": 256, "vocab_size": 256,
         "head_dim": 32, "tie_embeddings": True, "rope_theta": 10000.0,
         "norm_eps": 1e-05, "dtype": "float32", "sliding_window": 0}
TRAFFIC = {"n_clients": 2, "partition": "iid", "n_train": 64, "n_test": 8,
           "seq_len": 16, "policy": "fixed(b=4,cut=1)", "estimate": False,
           "eval_every": 4, "sfl": {"lr": 1.0, "agg_interval": 2}}
LIMITS = {"decision_mismatch": 0, "draw_mismatch": 0, "loss1_gap": 9e-05,
          "loss_gap": 0.00014, "grad1_gap": 0.025, "delta_gap": 0.0075,
          "agg_delta_gap": 0.01}
BENCH = {"workloads": [{"name": "tiny-window", "config": "tiny-window",
                        "traffic": "tiny-window", "chips": 1}],
         "end_to_end": [{"name": "rounds_per_s", "unit": "rounds/s"},
                        {"name": "setup_s", "unit": "s"},
                        {"name": "mfu", "unit": "%"}],
         "per_layer": []}


def _write(root, config: dict) -> None:
    sb = root / "simbench"
    for sub in ("configs", "traffic", "workloads", "reference"):
        (sb / sub).mkdir(parents=True, exist_ok=True)
    (sb / "reference" / "windowed.py").write_text(textwrap.dedent(MODULE))
    (sb / "configs" / "tiny-window.json").write_text(json.dumps(config))
    (sb / "traffic" / "tiny-window.json").write_text(json.dumps(TRAFFIC))
    (sb / "workloads" / "tiny-window.json").write_text(json.dumps(
        {"control": "fp8", "limits": LIMITS}))


def _config(**edit) -> dict:
    config = {"arch_id": NAME, "source": "a reduced test decoder",
              "reduced": [], "reference": "windowed", "model": dict(MODEL)}
    config.update(edit)
    return config


@pytest.fixture
def new_files(tmp_path, monkeypatch):
    """Files under ``tmp_path`` only: the harness's lookup points there."""
    monkeypatch.setattr(C, "ROOT", tmp_path)
    return tmp_path


def test_new_architecture_runs_from_new_files_alone(new_files):
    _write(new_files, _config())
    cell = C.find_cell(BENCH, "tiny-window")
    assert type(cell.arch).__name__ == "Arch"
    assert cell.arch.sliding_window == 0
    assert cell.ref.__file__ == str(new_files / "simbench" / "reference"
                                    / "windowed.py")
    _register(NAME, "smollm-tiny", MODEL)
    out = run_cell(BENCH, "tiny-window", 5, 0.05, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"rounds_per_s", "setup_s", "mfu"}


@pytest.mark.parametrize("config,named", [
    (_config(model=dict(MODEL, attn_offset=7)), "attn_offset"),
    (_config(reference="no-such-module"), "no-such-module.py"),
    ({k: v for k, v in _config().items() if k != "reference"},
     '"reference"')])
def test_configuration_is_refused_by_name(new_files, config, named):
    _write(new_files, config)
    with pytest.raises((KeyError, ValueError, FileNotFoundError)) as e:
        C.find_cell(BENCH, "tiny-window")
    assert named in str(e.value)
    assert "tiny-window.json" in str(e.value)


def test_the_decoder_refuses_a_key_it_does_not_read():
    ref = contract.load("decoder", C.BENCH / "reference")
    with pytest.raises(ValueError, match="sliding_window"):
        ref.make_arch(MODEL)


def test_a_module_init_draws_nothing():
    """A leaf with the module's own ``init`` takes no draw: the drawn
    leaves around it read as they do without it."""
    from types import SimpleNamespace

    import torch

    from simbench.reference.params import make_units

    def log_range(shape, dtype, device):
        return torch.log(torch.arange(1, shape[-1] + 1, dtype=dtype,
                                      device=device)).expand(shape)

    drawn = [(0, ("a",), (3, 2), "float32", 0.5),
             (1, ("c",), (4,), "float32", 2.0)]
    own = drawn[:1] + [(0, ("b",), (2, 4), "float32", log_range)] + drawn[1:]
    plain = make_units(SimpleNamespace(leaf_specs=lambda a: drawn), None,
                       7, "cpu")
    mine = make_units(SimpleNamespace(leaf_specs=lambda a: own), None,
                      7, "cpu")
    assert torch.equal(mine[0]["a"], plain[0]["a"])
    assert torch.equal(mine[1]["c"], plain[1]["c"])
    assert torch.equal(mine[0]["b"][1], torch.log(torch.arange(1.0, 5.0)))
