"""The port's CNN models against the JAX reference, on the CPU.

Narrow vgg9 and resnet10 variants (same layer structure as the registered
CPU-scale configs, 16x16 images) carry the reference's initial weights
across; the stacked per-client losses and their gradients must agree at
fp32 tolerance (the port's stacked path on the CPU is the plain im2col
GEMM; the reference's is its own im2col einsum path): losses within
1e-5, gradients within 1e-4 relative / 1e-5 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.models import cnn as RCNN
from repro.models import build_model as r_build
from repro_torch.convert import units_from_numpy, units_to_numpy
from repro_torch.models import build_model as t_build
from repro_torch.models import cnn as TCNN
from repro_torch.utils.tree import tree_leaves

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
VARIANTS = {
    "vgg9-torch-narrow": ("vgg9-cifar-small",
                          dict(conv_channels=(8, 16, 16), fc_dims=(32,),
                               image_size=16)),
    # 8 -> 16 channels: the stride-2 stage with its 3x3 projection conv
    "resnet10-torch-narrow": ("resnet10-cifar-small",
                              dict(conv_channels=(8, 16, 16),
                                   image_size=16)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch):
    """(reference cfg, port cfg) of a narrow variant, registered in both."""
    base, kw = VARIANTS[arch]
    out = []
    for C in (RC, TC):
        cfg = dataclasses.replace(C.get_config(base), arch_id=arch, **kw)
        out.append(C.register(cfg))
    return out


def _stacked_inputs(rcfg, n=3, b=5, seed=0):
    """Reference init replicated over n clients (each slightly perturbed so
    clients differ), a batch, and a loss mask with padded rows."""
    units = jax.tree_util.tree_map(
        np.asarray, r_build(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    stacked = jax.tree_util.tree_map(
        lambda a: np.stack([a + 0.01 * rng.standard_normal(a.shape)
                            for _ in range(n)]).astype(np.float32), units)
    s = rcfg.image_size
    images = rng.standard_normal((n, b, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, rcfg.n_classes, (n, b)).astype(np.int32)
    mask = np.ones((n, b), np.float32)
    mask[0, -2:] = 0.0                    # padded rows on client 0
    mask[-1] = 0.0                        # an all-padded client
    return stacked, images, labels, mask


@pytest.mark.parametrize("arch", sorted(VARIANTS))
def test_stacked_loss_and_grads_match_reference(arch):
    rcfg, tcfg = _configs(arch)
    stacked, images, labels, mask = _stacked_inputs(rcfg)

    def ref_total(params):
        losses = RCNN.cnn_stacked_loss(
            params, jnp.asarray(images), jnp.asarray(labels), rcfg,
            loss_mask=jnp.asarray(mask), impl="im2col")
        return losses.sum(), losses

    g_ref, l_ref = jax.jit(jax.grad(ref_total, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, stacked))

    params = units_from_numpy(stacked, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    losses = TCNN.cnn_stacked_loss(
        params, torch.from_numpy(images), torch.from_numpy(labels), tcfg,
        loss_mask=torch.from_numpy(mask))
    losses.sum().backward()

    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(l_ref),
                               **LOSS_TOL)
    assert float(losses[-1].detach()) == 0.0   # max(mask.sum, 1) denominator
    g_port = [t.grad.numpy() for t in tree_leaves(params)]
    g_jax = [np.asarray(x) for x in jax.tree_util.tree_leaves(g_ref)]
    assert len(g_port) == len(g_jax)
    for a, b in zip(g_port, g_jax):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(VARIANTS))
def test_single_model_loss_matches_reference(arch):
    """The port's single-model loss (the stacked path at N=1) against the
    reference's per-model lax.conv path."""
    rcfg, tcfg = _configs(arch)
    units = jax.tree_util.tree_map(
        np.asarray, r_build(rcfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    s = rcfg.image_size
    batch = {"images": rng.standard_normal((6, s, s, 3)).astype(np.float32),
             "labels": rng.integers(0, rcfg.n_classes, 6).astype(np.int32),
             "loss_mask": np.asarray([1, 1, 1, 1, 0, 0], np.float32)}
    (l_ref, aux_ref), g_ref = jax.jit(jax.value_and_grad(
        r_build(rcfg).loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, units),
            {k: jnp.asarray(v) for k, v in batch.items()})

    params = units_from_numpy(units, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, aux = t_build(tcfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **LOSS_TOL)
    assert float(aux["accuracy"]) == float(aux_ref["accuracy"])
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("arch", ["vgg16-cifar", "vgg9-cifar-small",
                                  "resnet18-cifar", "resnet10-cifar-small"])
def test_init_shapes_match_reference(arch):
    """The port's own seeded init has the reference's unit structure,
    shapes and (zero) biases."""
    r_units = jax.eval_shape(
        lambda k: r_build(RC.get_config(arch)).init(k),
        jax.random.PRNGKey(0))
    t_units = units_to_numpy(t_build(TC.get_config(arch)).init(
        torch.Generator().manual_seed(0)))
    r_leaves = jax.tree_util.tree_leaves(r_units)
    t_leaves = tree_leaves(t_units)
    assert [tuple(a.shape) for a in r_leaves] == [a.shape for a in t_leaves]
    assert all(np.all(b == 0) for u in t_units for b in [u["b"]])


def test_max_pool_and_nhwc_flatten_match_reference():
    """2x2 VALID pooling on an odd spatial size and the NHWC flatten order
    before the first FC layer (an NCHW flatten would permute it)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 5, 5, 4)).astype(np.float32)
    ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                (1, 1, 2, 2, 1), (1, 1, 2, 2, 1), "VALID")
    out = TCNN._max_pool_2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        out.reshape(2, 3, -1).numpy(), np.asarray(ref).reshape(2, 3, -1))


@pytest.mark.parametrize("arch", ["vgg16-cifar", "resnet18-cifar"])
def test_reduced_cnn_config_raises_like_reference(arch):
    """`reduced()` divides by ``n_heads`` (0 on every CNN config) through
    ``resolved_head_dim``; the reference raises ZeroDivisionError and the
    port's copy keeps that behaviour (a recorded reference fault)."""
    for C in (RC, TC):
        with pytest.raises(ZeroDivisionError):
            C.reduced(C.get_config(arch))
