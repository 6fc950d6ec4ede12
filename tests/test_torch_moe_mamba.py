"""The port's MoE, mamba, encoder-decoder and VLM modules against the JAX
reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages;
weights are the reference's, carried across as numpy.  Bars: fp32 1e-5 for
one module (the two sides differ only in the order of fp32 sums), and the
MoE router's decisions (top-k experts, which tokens drop) bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.configs.input_shapes import concrete_inputs as r_inputs
from repro.models import build_model as r_build
from repro.models import factory as RF
from repro.models import mamba as RMB
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs.input_shapes import concrete_inputs as t_inputs
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model as t_build
from repro_torch.models import factory as TF
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(tree):
    """numpy/jax leaves -> fp32 CPU tensors (same dict structure)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(seed, d, d_ff, n_experts, skew):
    """The reference's init, with ``skew`` added to expert 0's router
    column (tokens are drawn with a positive mean, so most pick it)."""
    p = RM.moe_init(jax.random.PRNGKey(seed), d, d_ff, n_experts,
                    jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, p)
    p["w_router"] = p["w_router"].copy()
    p["w_router"][:, 0] += skew
    return p


def _reference_keep(p, x, top_k, capacity):
    """Which (token, k) pairs the reference keeps, from its own ops."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["w_router"]), -1)
    flat = jax.lax.top_k(probs, top_k)[1].reshape(-1)
    onehot = jax.nn.one_hot(flat, p["w_router"].shape[-1], dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - 1, flat[:, None],
                              axis=1)[:, 0]
    return np.asarray(pos < capacity)


def _port_keep(p, x, top_k, capacity):
    probs = torch.softmax(torch.tensor(x) @ torch.tensor(p["w_router"]), -1)
    flat = TM.top_k_lower_first(probs, top_k)[1].reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, p["w_router"].shape[-1])
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    return (pos < capacity).numpy()


@pytest.mark.parametrize("top_k,n_experts", [(1, 8), (2, 4), (4, 16)])
def test_moe_ffn_with_overflow_matches_reference(top_k, n_experts):
    """capacity_factor 1.0 and a router skewed to expert 0: tokens drop.
    The dropped (token, k) pairs are the reference's, bitwise (a kept pair
    would add its expert's output), the output within 1e-5, the three aux
    values within 1e-5."""
    t, d, d_ff = 48, 16, 32
    rng = np.random.default_rng(top_k)
    x = (rng.standard_normal((t, d)) + 0.5).astype(np.float32)
    p = _moe_params(top_k, d, d_ff, n_experts, skew=1.5)
    ref, raux = RM.moe_ffn(p, jnp.asarray(x), top_k=top_k,
                           capacity_factor=1.0)
    got, taux = TM.moe_ffn(_t(p), torch.tensor(x), top_k=top_k,
                           capacity_factor=1.0)
    capacity = int(max(top_k, np.ceil(t * top_k / n_experts)))
    keep = _reference_keep(p, x, top_k, capacity)
    assert not keep.all()
    np.testing.assert_array_equal(_port_keep(p, x, top_k, capacity), keep)
    if top_k == 1:  # a dropped token's output row is exactly zero
        np.testing.assert_array_equal((_np(got) == 0).all(-1), ~keep)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    assert abs(float(raux["dropped_frac"]) - (1 - keep.mean())) < 1e-6
    for key in ("lb_loss", "router_entropy", "dropped_frac"):
        np.testing.assert_allclose(float(taux[key]), float(raux[key]), **TOL)


def test_moe_top_k_takes_the_lower_index_on_ties():
    """``jax.lax.top_k``'s order among equal values: lower index first."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25] * 4, [0.4, 0.1, 0.4, 0.1]],
                     np.float32)
    ref = np.asarray(jax.lax.top_k(jnp.asarray(probs), 3)[1])
    got = TM.top_k_lower_first(torch.tensor(probs), 3)[1].numpy()
    np.testing.assert_array_equal(got, ref)


def test_moe_token_chunk_path_matches_reference():
    """A stream of 2 x MOE_TOKEN_CHUNK tokens goes chunk by chunk on both
    sides (each chunk its own capacity), at a tiny width."""
    assert TM.MOE_TOKEN_CHUNK == RM.MOE_TOKEN_CHUNK
    t, d = 2 * TM.MOE_TOKEN_CHUNK, 4
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((t, d)) + 0.3).astype(np.float32)
    p = _moe_params(3, d, 8, 4, skew=0.5)
    ref, raux = RM.moe_ffn(p, jnp.asarray(x), top_k=2, capacity_factor=1.0)
    got, taux = TM.moe_ffn(_t(p), torch.tensor(x), top_k=2,
                           capacity_factor=1.0)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    np.testing.assert_allclose(float(taux["lb_loss"]), float(raux["lb_loss"]),
                               **TOL)
    assert taux["dropped_frac"] == raux["dropped_frac"] == 0.0


def test_moe_init_draws_experts_into_the_leaf_dtype():
    """Expert weights come out ``[*lead, E, in, out]`` in the model's type
    with the reference's scale (1/sqrt(in)); the router stays fp32."""
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, 64, 128, 4, torch.bfloat16, "cpu", lead=(2,))
    assert p["w_router"].dtype == torch.float32
    assert p["w_router"].shape == (2, 64, 4)
    for name, shape in (("w_gate", (2, 4, 64, 128)), ("w_up", (2, 4, 64, 128)),
                        ("w_down", (2, 4, 128, 64))):
        w = p[name]
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == shape
        std = float(w.float().std())
        assert abs(std * np.sqrt(shape[2]) - 1) < 0.05, (name, std)
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

D, D_IN, N_STATE, K_CONV = 24, 48, 4, 4


def _mamba(seed=0):
    p = RMB.mamba_init(jax.random.PRNGKey(seed), D, expand=D_IN // D,
                       state_dim=N_STATE, conv_dim=K_CONV,
                       dtype=jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, p)
    # a non-zero conv bias and skip, so every term is exercised
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.standard_normal(D_IN).astype(np.float32) * 0.1
    p["d_skip"] = rng.uniform(0.5, 1.5, D_IN).astype(np.float32)
    return p


def test_mamba_block_matches_reference():
    p = _mamba()
    x = np.random.default_rng(1).standard_normal((2, 70, D)).astype(
        np.float32)
    ref = RMB.mamba_block(p, jnp.asarray(x), state_dim=N_STATE)
    got = TMB.mamba_block(_t(p), torch.tensor(x), state_dim=N_STATE)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_mamba_decode_matches_reference_and_the_full_forward():
    """Token by token from the empty state: each step equals the
    reference's step, and the steps equal the full-sequence forward."""
    p = _mamba(2)
    tp = _t(p)
    x = np.random.default_rng(3).standard_normal((2, 12, D)).astype(
        np.float32)
    full = _np(TMB.mamba_block(tp, torch.tensor(x), state_dim=N_STATE))
    rs = RMB.mamba_decode_init(2, D_IN, N_STATE, K_CONV)
    ts = TMB.mamba_decode_init(2, D_IN, N_STATE, K_CONV)
    for i in range(x.shape[1]):
        rout, rs = RMB.mamba_block_decode(p, jnp.asarray(x[:, i:i + 1]), rs,
                                          state_dim=N_STATE)
        tout, ts = TMB.mamba_block_decode(tp, torch.tensor(x[:, i:i + 1]),
                                          ts, state_dim=N_STATE)
        np.testing.assert_allclose(_np(tout), _np(rout), **TOL)
        np.testing.assert_allclose(_np(tout)[:, 0], full[:, i], **TOL)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(_np(ts[key]), _np(rs[key]), **TOL)


def test_mamba_block_bf16_rounds_where_the_reference_rounds():
    """In bf16 the conv output, ``bc`` and ``dt`` are rounded to the
    stream type and the state runs in fp32 on both sides: the outputs
    agree within a few bf16 ulps (the bar of the serving tests)."""
    p = _mamba(4)
    x = np.random.default_rng(5).standard_normal((2, 40, D)).astype(
        np.float32)
    ref = RMB.mamba_block(
        jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16) if a.shape in (
                (D, 2 * D_IN), (D_IN, D)) else jnp.asarray(a), p),
        jnp.asarray(x, jnp.bfloat16), state_dim=N_STATE)
    tp = _t(p)
    for name in ("w_in", "w_out"):
        tp[name] = tp[name].to(torch.bfloat16)
    got = TMB.mamba_block(tp, torch.tensor(x).to(torch.bfloat16),
                          state_dim=N_STATE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0.07, atol=0.05)


def _model_pair(arch, dtype="float32"):
    rcfg = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype)
    rp = r_build(rcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), tcfg,
                           "cpu")
    return rcfg, tcfg, rp, tp


def test_jamba_decode_after_prefill_starts_from_an_empty_mamba_state():
    """The reference's prefill leaves the mamba caches as initialized
    (`stack_prefill`'s quirk, kept): after prefill they equal a fresh
    cache's on both sides, and the first decode step is the one taken with
    those leaves reset to a fresh cache's."""
    rcfg, tcfg, rp, tp = _model_pair("jamba-v0.1-52b")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 8))
    _, rcache = r_build(rcfg).prefill(rp, {"tokens": jnp.asarray(toks)},
                                      cache_len=12)
    tm = t_build(tcfg)
    _, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks)},
                           cache_len=12)
    fresh = tm.init_cache(2, 12)
    mixers = [f"l{li}" for li, layer in enumerate(
        RT.layer_program(rcfg)[0]) if layer[0] == "mamba"]
    assert mixers
    for li in mixers:
        ref_leaves = jax.tree_util.tree_leaves(rcache[li]["b0"])
        for a, b, c in zip(tree_leaves(tcache[li]["b0"]), ref_leaves,
                           tree_leaves(fresh[li]["b0"])):
            np.testing.assert_array_equal(_np(a), _np(b))
            np.testing.assert_array_equal(_np(a), _np(c))
    step = {"tokens": torch.as_tensor(toks[:, :1]),
            "positions": torch.full((2,), 8, dtype=torch.int32)}
    reset = {k: ({**v, "b0": fresh[k]["b0"]} if k in mixers else v)
             for k, v in tcache.items()}
    a, _ = tm.decode_step(tp, reset, dict(step))
    b, _ = tm.decode_step(tp, tcache, dict(step))
    np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper) and VLM (internvl2)
# ---------------------------------------------------------------------------

def test_whisper_xattn_cache_holds_the_encoder_kv_of_the_reference():
    """Prefill writes each decoder layer's cross-attention K/V of the
    encoder output into its cache: equal to the reference's, and to
    ``enc_out @ wk`` (``wv``) of the port's own encoder."""
    rcfg, tcfg, rp, tp = _model_pair("whisper-medium")
    shape = ("serve", 8, 2, "prefill")
    rin = r_inputs(rcfg, RC.InputShape(*shape))
    tin = {k: torch.as_tensor(v)
           for k, v in t_inputs(tcfg, TC.InputShape(*shape)).items()}
    _, rcache = r_build(rcfg).prefill(
        rp, {k: jnp.asarray(v) for k, v in rin.items()}, cache_len=12)
    _, tcache = t_build(tcfg).prefill(tp, tin, cache_len=12)
    hd, senc = tcfg.resolved_head_dim, tcfg.encoder_seq
    for r in range(tcfg.n_layers):
        xt = {k: _np(v[r]) for k, v in tcache["l0"]["b1"].items()}
        xr = {k: _np(v[r]) for k, v in rcache["l0"]["b1"].items()}
        assert sorted(xt) == sorted(xr) == ["k", "v"]
        for key in ("k", "v"):
            assert xt[key].shape == (2, senc, tcfg.n_kv_heads, hd)
            assert np.abs(xt[key]).max() > 0
            np.testing.assert_allclose(xt[key], xr[key], rtol=1e-4,
                                       atol=1e-4)
    # the port's own encoder output, projected by layer 0's weights
    p0 = {k: v[0] for k, v in tp["stack"]["l0"]["b1"].items()}
    enc_out = _encode_port(tcfg, tp, tin["frame_embeddings"])
    k0, v0 = TT._xattn_kv(p0, tcfg, enc_out)
    np.testing.assert_array_equal(_np(tcache["l0"]["b1"]["k"][0]), _np(k0))
    np.testing.assert_array_equal(_np(tcache["l0"]["b1"]["v"][0]), _np(v0))


def _encode_port(cfg, params, frames):
    """The port's encoder (stack, sinusoidal positions, final norm)."""
    prog, _ = TT.encoder_program(cfg)
    s = frames.shape[1]
    x = frames.to(torch.float32) + TL.sinusoidal_table(
        s, cfg.d_model, torch.float32, "cpu")[None]
    x = TT.stack_fwd(params["enc_stack"], x, cfg, prog,
                     {"positions": torch.arange(s)[None, :]})
    return TL.rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


@pytest.mark.parametrize("seq", [1, 16, 1500, 8192])
def test_sinusoidal_table_rows_are_the_references(seq):
    """The cached table's first ``seq`` rows are the numpy function's
    (which is the reference's, copied), whatever length was asked."""
    from repro.models.layers import sinusoidal_positions as r_sin

    want = r_sin(seq, 64)
    np.testing.assert_array_equal(TL.sinusoidal_positions(seq, 64), want)
    np.testing.assert_array_equal(
        TL.sinusoidal_table(seq, 64, torch.float32, "cpu").numpy(), want)


@pytest.mark.parametrize("pattern", ["first8", "scattered", "none", "all"])
def test_merge_patches_places_patches_as_the_reference(pattern):
    rng = np.random.default_rng(9)
    b, s, p, d = 3, 20, 6, 8
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    patches = rng.standard_normal((b, p, d)).astype(np.float32)
    mask = {"first8": np.arange(s) < 8,
            "scattered": rng.random((b, s)) < 0.4,
            "none": np.zeros(s, bool),
            "all": np.ones(s, bool)}[pattern]
    mask = np.broadcast_to(mask, (b, s)).copy()
    ref = RF._merge_patches(jnp.asarray(x), jnp.asarray(patches),
                            jnp.asarray(mask))
    got = TF._merge_patches(torch.tensor(x), torch.tensor(patches),
                            torch.tensor(mask))
    np.testing.assert_array_equal(_np(got), _np(ref))
