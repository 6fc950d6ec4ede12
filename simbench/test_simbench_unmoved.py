"""What each cell's configuration module computes, held bitwise to the
numbers the benchmark computed before the architecture code moved into
the reference modules (`test_simbench_unmoved.json`): the initial units
and every reference reading (sound, the control and each fault variant)
at the tests' small size, and every count and the estimate's
unit-to-layer spans at the cells' real widths.
CPU, one torch thread (the CPU's reductions split by thread count)."""
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from simbench import cell as C
from simbench.harness import reader
from simbench.reference.params import leaf_names, leaves, make_units
from simbench.reference.rounds import VARIANTS, first_rounds
from simbench.test_simbench_reference import small

BENCH = C.load_benchmark()
DATA = json.loads(Path(__file__).with_suffix(".json").read_text())
CELLS = sorted(DATA["cells"])
READERS = ("mfu", "k1_gemm_roofline", "attn_roofline", "rmsnorm_roofline")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(t) -> str:
    t = t.detach().cpu().contiguous()
    h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _small_cell(name):
    cell = C.find_cell(BENCH, name)
    small(cell)
    return cell


def _readings(r) -> dict:
    return {"b": [int(x) for x in r["b"]], "cuts": [int(x) for x in r["cuts"]],
            "draws": [[[int(i) for i in d] for d in rd] for rd in r["draws"]],
            "losses": [[float(x) for x in row] for row in r["losses"]],
            "grad1": [float(x) for x in r["grad1"]],
            "delta": [float(x) for x in r["delta"]],
            "agg_delta": [float(x) for x in r["agg_delta"]]}


@pytest.mark.parametrize("name", CELLS)
def test_initial_units_unmoved(name, one_thread):
    cell = _small_cell(name)
    units0 = make_units(cell.ref, cell.arch, DATA["seed"], "cpu")
    got = [[n, _digest(x)] for n, x in zip(leaf_names(units0),
                                          leaves(units0))]
    assert got == DATA["cells"][name]["units"]


@pytest.mark.parametrize("variant", [str(v) for v in VARIANTS])
@pytest.mark.parametrize("name", CELLS)
def test_reference_readings_unmoved(name, variant, one_thread):
    cell = _small_cell(name)
    units0 = make_units(cell.ref, cell.arch, DATA["seed"], "cpu")
    r = first_rounds(cell.ref, cell.arch, cell.traffic, DATA["seed"], units0,
                     "cpu", variant=None if variant == "None" else variant)
    want = DATA["cells"][name]["readings"][variant]
    got = _readings(r)
    for key in want:
        assert got[key] == want[key], key


class _Trace:
    def seconds(self, kernels, within=None):
        return 1.0


@pytest.mark.parametrize("name", CELLS)
def test_counts_unmoved(name):
    want = DATA["cells"][name]["counts"]
    cell = C.find_cell(BENCH, name)
    ref, arch, traffic = cell.ref, cell.arch, cell.traffic
    n = traffic["n_clients"]
    rows, seq = n * 24, traffic.get("seq_len", 0)
    assert (rows, seq) == (want["rows"], want["seq"])
    bound = reader("attn_roofline").__globals__["bound_seconds"]
    norms = ref.norms_per_step(arch)
    got = {"train_flops": ref.train_flops(arch, rows, seq),
           "conv_gemm_flops": ref.conv_gemm_flops(arch),
           "attn_bound_seconds": (None if ref.attention_calls(arch) is None
                                  else bound(ref, arch, rows, seq)),
           "rmsnorm_bytes": (None if norms is None else norms * sum(
               ref.norm_call_bytes(arch, rows * seq, n)))}
    for key, value in got.items():
        assert value == want[key], key
    spans = want["spans"]
    assert ref.leaf_specs(arch)[-1][0] + 1 == spans["n_units"]
    assert [list(s) for s in ref.unit_layer_spans(
        arch, spans["n_units"], spans["n_layers"])] == spans["spans"]
    ctx = SimpleNamespace(
        arch=arch, traffic=traffic, ref=ref, trace=_Trace(), window_s=1.0,
        segments=[{"t0": 0, "rounds": 1, "counts": [24] * n}])
    assert {m: reader(m)(ctx) for m in READERS} == want["reads"]
