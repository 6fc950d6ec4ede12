"""The port's sharding plan (`repro_torch.dist.sharding`) against the
reference's (`repro.dist.sharding`), spec for spec, on the production
meshes (16 x 16 and 2 x 16 x 16), and the SPMD step's GSPMD arguments.

The reference builds `NamedSharding`s, which need a `jax.sharding.Mesh`
of 256 or 512 devices; here its inference runs on a duck-typed mesh (as
its own ``tests/test_dist_sharding.py`` does) with `NamedSharding`
replaced by the bare `PartitionSpec`, so each leaf's per-dimension axis
assignment is compared as a tuple.  The port runs on its own mesh-shaped
object and, once, on a `DeviceMesh` under the ``fake`` backend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.dist.sharding as RSH
import repro_torch.config as TC
from repro.core.sfl import make_hasfl_train_step as r_step
from repro.mesh import sharded as RMS
from repro.models import build_model as r_build
from repro_torch.core.sfl import make_hasfl_train_step as t_step
from repro_torch.dist import sharding as TSH
from repro_torch.launch import mesh as TM
from repro_torch.mesh import sharded as TMS
from repro_torch.models import build_model as t_build
from repro_torch.utils.tree import tree_leaves


class _FakeMesh:
    """Duck-typed mesh (shape + axis_names), as the reference's tests."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

ADVERSARIAL_SHAPES = [   # the reference's tests/test_dist_sharding.py
    (), (1,), (3,), (9, 64), (14, 96), (17, 17), (5120, 202048),
    (2, 3, 5, 7), (32, 1, 16), (48, 48),
    # the expert layout: [R, E, d, d_ff], E divisible or not
    (4, 16, 4096, 14336), (4, 6, 4096, 14336), (2, 128, 5120, 8192),
]
ARCHS = ["smollm-135m", "qwen3-1.7b", "glm4-9b", "phi3-mini-3.8b",
         "xlstm-350m", "jamba-v0.1-52b", "dbrx-132b",
         "llama4-maverick-400b-a17b", "whisper-medium", "internvl2-1b"]


def _meshes(name):
    return _FakeMesh(MESHES[name]), TM.MeshShape(MESHES[name])


def _spec(s):
    return tuple(getattr(s, "spec", s))


@pytest.fixture
def bare_ref(monkeypatch):
    """The reference's tree functions returning bare PartitionSpecs."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ADVERSARIAL_SHAPES,
                         ids=[str(s) for s in ADVERSARIAL_SHAPES])
def test_auto_and_client_specs_equal_the_references(mesh, shape):
    rmesh, tmesh = _meshes(mesh)
    for kw in ({}, {"expert": True}, {"skip": 1}, {"dp": False},
               {"tp": False}, {"expert": True, "skip": 2}):
        assert _spec(TSH.auto_param_spec(shape, tmesh, **kw)) == \
            _spec(RSH.auto_param_spec(shape, rmesh, **kw)), kw
    if shape:
        for axis in ("clients", "data"):
            assert _spec(TSH.client_axis_spec(shape, tmesh, axis)) == \
                _spec(RSH.client_axis_spec(shape, rmesh, axis))


def _paths_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(RSH._path_names(p)): _spec(x) for p, x in flat}


def _paths_port(tree):
    out = {}
    TSH._map_with_path(lambda p, x: out.__setitem__("/".join(p), _spec(x)),
                       tree)
    return out


def _ref_state(arch, n):
    cfg = RC.reduced(RC.get_config(arch))
    init, _ = r_step(r_build(cfg), n_clients=n, cut_reps=1, agg_interval=3)
    return cfg, jax.eval_shape(init, jax.random.PRNGKey(0))


def _port_state(arch, n):
    cfg = TC.reduced(TC.get_config(arch))
    init, _ = t_step(t_build(cfg), n_clients=n, cut_reps=1, agg_interval=3)
    return cfg, init(torch.Generator(), device="meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_cache_and_batch_shardings_equal_the_references(
        arch, mesh, bare_ref):
    """Every leaf of a reduced arch's SPMD state (one client per data
    slice), its serving params, its decode cache of 32 sequences and its
    train and decode batches: the same spec on both sides."""
    rmesh, tmesh = _meshes(mesh)
    n = 32 if mesh == "multi" else 16
    rcfg, rstate = _ref_state(arch, n)
    tcfg, tstate = _port_state(arch, n)
    ref = _paths_ref(RSH.state_shardings(rstate, rmesh))
    got = _paths_port(TSH.state_shardings(tstate, tmesh))
    ref.pop("step")
    assert got.pop("step") == ()
    assert got == ref
    # serving params and the decode cache
    rparams = jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0))
    tparams = t_build(tcfg).init(torch.Generator(), device="meta")
    assert _paths_port(TSH.state_shardings(tparams, tmesh)) == \
        _paths_ref(RSH.state_shardings(rparams, rmesh))
    rcache = jax.eval_shape(lambda: r_build(rcfg).init_cache(32, 24))
    tcache = t_build(tcfg).init_cache(32, 24, device="meta")
    for fn in ("cache_shardings", "cache_shardings_replicated"):
        assert _paths_port(getattr(TSH, fn)(tcache, tmesh)) == \
            _paths_ref(getattr(RSH, fn)(rcache, rmesh)), fn
    # batches: the train batch [N, b, S] (+ stubs) and the decode batch
    for kind, lead in (("train", n), ("decode", None)):
        shape = RC.InputShape("t", 16, 64, kind)
        from repro.configs.input_shapes import input_specs as r_specs
        from repro_torch.configs.input_shapes import input_specs as t_specs
        rb = {k: (v.shape if lead is None else
                  (lead, v.shape[0] // lead, *v.shape[1:]))
              for k, v in r_specs(rcfg, shape).items()}
        tb = {k: (s if lead is None else (lead, s[0] // lead, *s[1:]))
              for k, (s, _) in t_specs(tcfg, TC.InputShape(
                  "t", 16, 64, kind)).items()}
        assert rb == tb
        rbs = RSH.batch_shardings(
            {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in rb.items()},
            rmesh)
        tbs = TSH.batch_shardings(
            {k: torch.empty(s, device="meta") for k, s in tb.items()}, tmesh)
        assert _paths_port(tbs) == _paths_ref(rbs), kind


def test_production_device_mesh_and_placements():
    """A production mesh is a `DeviceMesh` under the fake backend (no
    card); a spec's DTensor placements shard a ``meta`` tensor to the
    spec's local shape."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = TM.make_production_mesh(multi_pod=True)
    try:
        assert TM.mesh_axes(mesh) == MESHES["multi"]
        assert TM.dp_axes(mesh) == ("pod", "data")
        assert TM.axis_size(mesh, ("pod", "data")) == 32
        spec = TSH.auto_param_spec((64, 4096), mesh)
        assert _spec(spec) == (("pod", "data"), "model")
        sh = TSH.NamedSharding(mesh, spec)
        assert sh.placements == (Shard(0), Shard(0), Shard(1))
        assert TSH.NamedSharding(mesh, TSH.P(None, None)).placements == \
            (Replicate(),) * 3
        local = distribute_tensor(torch.empty(64, 4096, device="meta"),
                                  mesh, sh.placements).to_local()
        assert tuple(local.shape) == sh.shard_shape((64, 4096)) == (2, 256)
    finally:
        TM.release_production_mesh()
    mesh = TM.make_production_mesh()
    try:
        assert TM.mesh_axes(mesh) == MESHES["single"]
    finally:
        TM.release_production_mesh()
    assert not torch.distributed.is_initialized()


def test_client_stacked_specs_equal_the_references():
    """`mesh.sharded.stacked_specs` takes `client_axis_spec` from
    `dist.sharding`, as the reference's."""
    shapes = [{"w": (8, 3, 3, 16, 32), "b": (8, 32)}, {"w": (8, 64, 10)}]
    rmesh = _FakeMesh({"clients": 4})
    ref = RMS.stacked_specs(
        [{k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in u.items()}
         for u in shapes], rmesh, "clients")
    pm = TMS.ProcessMesh(group=None, d=4, rank=0, n=8)
    got = TMS.stacked_specs(
        [{k: torch.empty(s, device="meta") for k, s in u.items()}
         for u in shapes], pm)
    assert [{k: _spec(v) for k, v in u.items()} for u in got] == \
        [{k: _spec(v) for k, v in u.items()} for u in ref]


def test_hooks_leave_plain_tensors_and_log_their_shard_factor():
    tmesh = TM.MeshShape(MESHES["single"])
    shard, seq = TSH.make_shard_fn(tmesh), TSH.make_seq_shard_fn(tmesh)
    x = torch.empty(32, 64, 8, device="meta")
    assert shard(x) is x and seq(x) is x
    assert shard.log["divisor"] == 16 and seq.log["divisor"] == 256
    # the all-gather of the sequence: the local shard's bytes
    assert seq.log["seq_gather_bytes"] == 32 * 64 * 8 * 4 // 256
    assert TSH.make_shard_fn(None) is None
    host = TM.make_host_mesh()
    assert TSH.make_shard_fn(host)(x) is x
    rep = TSH.make_rep_shard_fn(tmesh)
    p = {"wq": torch.empty(64, 128, device="meta")}
    assert rep(p)["wq"] is p["wq"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_spmd_step_with_shardings_on_the_host_mesh_is_bitwise(grad_accum):
    """On one device the GSPMD arguments change no number: the step with
    ``shard_fn``, ``rep_shard_fn``, ``param_shardings`` and ``unroll`` of
    the host mesh equals the step without them, bitwise (2 steps, the
    second aggregating)."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("smollm-135m")),
                              dtype="float32")
    model = t_build(cfg)
    host = TM.make_host_mesh()
    kw = dict(n_clients=2, cut_reps=1, agg_interval=2, lr=1e-2,
              grad_accum=grad_accum, remat=True)
    init, plain = t_step(model, **kw)
    state0 = init(torch.Generator().manual_seed(0), device="cpu")
    sh = TSH.state_shardings(state0, host)
    _, sharded = t_step(model, **kw, shard_fn=TSH.make_shard_fn(host),
                        rep_shard_fn=TSH.make_rep_shard_fn(host),
                        unroll=True,
                        param_shardings=(sh["client"], sh["server"]))
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (2, 2, 8)))
                for k in ("tokens", "labels")} for _ in range(2)]
    runs = []
    for step in (plain, sharded):
        state = init(torch.Generator().manual_seed(0), device="cpu")
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, [t.detach().clone()
                              for t in tree_leaves(state)
                              if isinstance(t, torch.Tensor)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
