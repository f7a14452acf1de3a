"""The port's vision models against the JAX package's, on parameters from
the reference's own init carried across with ``repro_torch.convert``.

Bars (fp32 on the CPU, both sides at full matmul precision): 1e-5 relative
to the output's scale for the CNN and its gradient, 1e-4 for ResNet-18,
whose 20 conv + GroupNorm layers reorder more sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distillation as jD
from repro.models import layers as jL
from repro.models import vision as jV
from repro_torch import convert
from repro_torch.core import distillation as D
from repro_torch.models import layers as L
from repro_torch.models import vision as V


def images(seed, b, size):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


def assert_scaled_close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def jax_init(init, seed, **kw):
    """The reference's own init, jit'd (one compile instead of one per op)."""
    return jax.jit(lambda k: init(k, **kw))(jax.random.PRNGKey(seed))


def test_convert_round_trip():
    p = jax.tree.map(np.asarray, jax_init(jV.cnn_init, 0, width=8,
                                          image_size=16))
    t = convert.from_numpy(p, "cpu")
    assert tuple(t["c2"]["w"].shape) == (16, 8, 3, 3)        # OIHW
    assert tuple(t["f1"]["w"].shape) == p["f1"]["w"].shape   # (d_in, d_out)
    back = convert.to_numpy(t)
    jax.tree.map(np.testing.assert_array_equal, back, p)


@pytest.mark.parametrize("k,stride,size", [(3, 1, 8), (3, 2, 8), (1, 2, 8),
                                           (3, 2, 7), (3, 1, 5)])
def test_conv_same_padding(k, stride, size):
    """XLA "SAME": at stride 2 on an even input a 3x3 conv pads only the
    bottom/right."""
    rng = np.random.RandomState(k * 10 + stride)
    p = {"w": rng.randn(k, k, 4, 6).astype(np.float32),
         "b": rng.randn(6).astype(np.float32)}
    x = images(1, 2, size)[..., :3]
    x = np.concatenate([x, x[..., :1]], -1)                   # 4 channels
    want = jV.conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride)
    got = V.conv(convert.from_numpy(p, "cpu"),
                 torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    assert_scaled_close(got.permute(0, 2, 3, 1), want, 1e-6)


@pytest.mark.parametrize("c", [8, 48, 64])
def test_groupnorm(c):
    """48 channels reduce g from 32 to 24.  The reference's statistics span
    every group (see ``repro_torch.models.layers.groupnorm``)."""
    rng = np.random.RandomState(c)
    x = rng.randn(2, 5, 5, c).astype(np.float32) * 3 + 1
    p = {"scale": rng.randn(c).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    want = jL.groupnorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = L.groupnorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_scaled_close(got.permute(0, 2, 3, 1), want, 1e-6)


@pytest.mark.parametrize("width,size", [(8, 16), (32, 32)])
def test_cnn_logits_and_features(width, size):
    pj = jax_init(jV.cnn_init, width, width=width, image_size=size)
    pt = convert.from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    x = images(2, 4, size)
    with torch.no_grad():
        assert_scaled_close(V.cnn_apply(pt, torch.from_numpy(x)),
                            jax.jit(jV.cnn_apply)(pj, x), 1e-5)
        assert_scaled_close(V.cnn_features(pt, torch.from_numpy(x)),
                            jax.jit(jV.cnn_features)(pj, x), 1e-5)


def test_resnet18_logits_and_features():
    pj = jax_init(jV.resnet18_init, 3, n_classes=10)
    pt = convert.from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    x = images(3, 2, 16)
    with torch.no_grad():
        assert_scaled_close(V.resnet18_apply(pt, torch.from_numpy(x)),
                            jax.jit(jV.resnet18_apply)(pj, x), 1e-4)
        assert_scaled_close(V.resnet18_features(pt, torch.from_numpy(x)),
                            jax.jit(jV.resnet18_features)(pj, x), 1e-4)


def test_cnn_cross_entropy_gradient():
    pj = jax_init(jV.cnn_init, 5, width=8, image_size=16)
    pt = convert.from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    x = images(4, 8, 16)
    y = np.random.RandomState(4).randint(0, 10, 8).astype(np.int32)

    def jloss(p):
        return jD.cross_entropy(jV.cnn_apply(p, jnp.asarray(x)),
                                jnp.asarray(y))
    lj, gj = jax.jit(jax.value_and_grad(jloss))(pj)
    gt, lt = torch.func.grad_and_value(
        lambda p: D.cross_entropy(V.cnn_apply(p, torch.from_numpy(x)),
                                  torch.from_numpy(y)))(pt)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    gt = convert.to_numpy(gt)
    for path in ("c1", "c4", "f1", "head"):
        for leaf in ("w", "b"):
            assert_scaled_close(gt[path][leaf], gj[path][leaf], 1e-5)
