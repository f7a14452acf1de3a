"""The port's distillation losses and its KD kernel's plain versions, held
against the JAX package on the same numpy inputs.

Bars:

* the plain ``kd_loss`` against ``repro.kernels.ref.kd_loss`` and the
  Pallas ``kd_loss`` in interpret mode: atol 1e-5, rtol 1e-4 at
  ``test_kernels.py``'s shapes, and atol 2e-5, rtol 1e-3 over λ ∈ [0, 1]
  and τ ∈ [0.5, 4], the reference's own bars for its kernel;
* the plain closed-form backward against ``torch.autograd`` of the plain
  forward: within 1e-6 of the gradient's largest magnitude (both fp32 on
  the CPU, by different formulas);
* the folded, vmapped Functions against a Python loop over clients: the
  loss within 1e-6 and the gradient within 1e-6 of its largest magnitude
  (the same plain arithmetic, one call for all clients against one each);
* every ported loss against ``repro.core.distillation``: values within
  rtol 1e-5 (atol 1e-6) and gradients in the student logits (features for
  MOON) against ``jax.grad`` within 1e-5 of the gradient's largest
  magnitude.

On the card ``tests/test_torch_gpu.py`` holds the CUDA kernels against
these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distillation as JD
from repro.kernels import kd_loss as JKD
from repro.kernels import ref as jref
from repro_torch.core import distillation as D
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kd_loss import KDLoss


def kd_inputs(seed, B, C, scale=2.0):
    """Student and teacher logits, labels and ρ (C,) as numpy."""
    rng = np.random.RandomState(seed)
    s = (scale * rng.randn(B, C)).astype(np.float32)
    t = (scale * rng.randn(B, C)).astype(np.float32)
    y = rng.randint(0, C, B).astype(np.int32)
    rho = rng.uniform(0.0, 1.0, C).astype(np.float32)
    return s, t, y, rho


def th(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_grad_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, np.abs(got - want).max()


# ---------------------------------------------------------------------------
# the plain kd_loss against the reference's oracle and Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,C", [(8, 10), (64, 37), (128, 100), (31, 257)])
def test_plain_kd_loss_sweep(B, C):
    s, t, y, rho = kd_inputs(6, B, C)
    loss, ce, kl, stats = ref.kd_loss(*th(s, t, y, rho), 0.35, 2.0)
    assert loss.shape == ce.shape == kl.shape == (B,)
    assert stats.shape == (B, len(ref.KD_STATS))
    want = jref.kd_loss(s, t, y, rho, 0.35, 2.0)
    np.testing.assert_allclose(loss.numpy(), want, atol=1e-5, rtol=1e-4)
    pallas = JKD.kd_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y),
                         jnp.asarray(rho), 0.35, 2.0, interpret=True)
    np.testing.assert_allclose(loss.numpy(), pallas, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose((0.65 * ce + 0.35 * kl).numpy(), loss.numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lam", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("tau", [0.5, 1.7, 4.0])
def test_plain_kd_loss_hparams(lam, tau):
    s, t, y, rho = kd_inputs(7, 16, 12)
    loss = ref.kd_loss(*th(s, t, y, rho), lam, tau)[0].numpy()
    pallas = JKD.kd_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y),
                         jnp.asarray(rho), lam, tau, interpret=True)
    np.testing.assert_allclose(loss, pallas, atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(loss, jref.kd_loss(s, t, y, rho, lam, tau),
                               atol=2e-5, rtol=1e-3)
    assert np.all(np.isfinite(loss))


@pytest.mark.parametrize("B,C,G", [(8, 10, 1), (64, 37, 1), (31, 257, 1),
                                   (24, 10, 3)])
@pytest.mark.parametrize("lam,tau", [(0.35, 1.0), (0.8, 3.0)])
def test_plain_backward_matches_autograd(B, C, G, lam, tau):
    """The closed-form backward, with per-row upstream gradients and ρ of G
    groups (one class fully confident, so its target sits at the clip)."""
    rng = np.random.RandomState(B + C)
    s, t, y, _ = kd_inputs(B * C, B, C)
    rho = rng.uniform(0.0, 1.0, (G, C)).astype(np.float32)
    rho[:, 0] = 1.0
    g = rng.uniform(0.1, 1.0, B).astype(np.float32)
    s_t, t_t, y_t, rho_t, g_t = th(s, t, y, rho, g)
    s_t.requires_grad_()
    loss, _, _, stats = ref.kd_loss(s_t, t_t, y_t, rho_t, lam, tau)
    (loss * g_t).sum().backward()
    got = ref.kd_loss_bwd(s_t.detach(), t_t, y_t, rho_t, stats.detach(), g_t,
                          lam, tau)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    assert_grad_close(got.numpy(), s_t.grad.numpy(), 1e-6)


def test_plain_backward_keeps_the_logits_dtype():
    s, t, y, rho = kd_inputs(3, 8, 10)
    sb, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (s, t))
    y_t, rho_t = th(y, rho)
    stats = ref.kd_loss(sb, tb, y_t, rho_t, 0.35, 1.0)[3]
    ds = ref.kd_loss_bwd(sb, tb, y_t, rho_t, stats, torch.ones(8), 0.35, 1.0)
    assert ds.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the vmap rules: one folded call for all clients against a loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("teacher_batched", [True, False])
@pytest.mark.parametrize("rho_batched", [True, False])
def test_folded_vmap_matches_loop_over_clients(teacher_batched, rho_batched):
    """vmap(grad_and_value) through the KD Functions folds K clients into
    one call with ρ (K, C), b rows each; every client's loss and gradient
    equals its own unbatched call.  Distinct ρ per client and distinct
    rows make a wrong fold (clients' ρ mixed) show."""
    K, b, C = 4, 6, 9
    rng = np.random.RandomState(11)
    s = rng.randn(K, b, C).astype(np.float32) * 2
    t = rng.randn(K, b, C).astype(np.float32) * 2
    y = rng.randint(0, C, (K, b))
    rho = rng.uniform(0, 1, (K, C)).astype(np.float32)
    s_t, t_t, y_t, rho_t = th(s, t, y, rho)
    t_in = t_t if teacher_batched else t_t[0]
    rho_in = rho_t if rho_batched else rho_t[0]
    lam, tau = 0.35, 2.0

    def f(s, t, y, r):
        return ops.kd_loss(s, t, y, r, lam, tau)[0].mean()
    in_dims = (0, 0 if teacher_batched else None, 0,
               0 if rho_batched else None)
    g, v = torch.func.vmap(torch.func.grad_and_value(f), in_dims=in_dims)(
        s_t, t_in, y_t, rho_in)
    assert g.shape == (K, b, C) and v.shape == (K,)
    for k in range(K):
        sk = s_t[k].clone().requires_grad_()
        tk = t_t[k] if teacher_batched else t_t[0]
        rk = rho_t[k] if rho_batched else rho_t[0]
        loss = ops.kd_loss(sk, tk, y_t[k], rk, lam, tau)[0].mean()
        loss.backward()
        assert abs(float(loss.detach()) - float(v[k])) <= 1e-6
        assert_grad_close(g[k].numpy(), sk.grad.numpy(), 1e-6)


def test_grouped_rho_equals_per_group_calls():
    """ρ (G, C) with B/G rows per group equals G separate calls."""
    G, b, C = 3, 5, 7
    s, t, y, _ = kd_inputs(2, G * b, C)
    rho = np.random.RandomState(2).uniform(0, 1, (G, C)).astype(np.float32)
    s_t, t_t, y_t, rho_t = th(s, t, y, rho)
    whole = KDLoss.apply(s_t, t_t, y_t, rho_t, 0.5, 1.5)
    for k in range(G):
        rows = slice(k * b, (k + 1) * b)
        part = KDLoss.apply(s_t[rows], t_t[rows], y_t[rows], rho_t[k:k + 1],
                            0.5, 1.5)
        for a, w in zip(whole, part):
            torch.testing.assert_close(a[rows], w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the ported losses against repro.core.distillation
# ---------------------------------------------------------------------------
def check_loss(port_fn, ref_fn, *arrays, grad_arg=0):
    """Values (first output and its aux dict) and the gradient in argument
    ``grad_arg`` against ``jax.grad`` of the reference."""
    torch_args = [torch.from_numpy(np.array(a)) for a in arrays]
    torch_args[grad_arg].requires_grad_()
    got = port_fn(*torch_args)
    want = ref_fn(*[jnp.asarray(a) for a in arrays])
    got_v, got_aux = got if isinstance(got, tuple) else (got, {})
    want_v, want_aux = want if isinstance(want, tuple) else (want, {})
    np.testing.assert_allclose(float(got_v.detach()), float(want_v),
                               rtol=1e-5, atol=1e-6)
    for key, val in want_aux.items():
        np.testing.assert_allclose(float(got_aux[key].detach()), float(val),
                                   rtol=1e-5, atol=1e-6)
    got_v.backward()

    def scalar(*a):
        out = ref_fn(*a)
        return out[0] if isinstance(out, tuple) else out
    jgrad = jax.grad(scalar, argnums=grad_arg)(*[jnp.asarray(a)
                                                 for a in arrays])
    assert_grad_close(torch_args[grad_arg].grad.numpy(), jgrad, 1e-5)


@pytest.mark.parametrize("B,C", [(16, 10), (64, 100)])
def test_self_confidence_kd_loss(B, C):
    s, t, y, _ = kd_inputs(B, B, C)
    counts = np.random.RandomState(C).randint(0, 50, C).astype(np.float32)
    counts[1] = 0.0
    check_loss(lambda s, t, y, c: D.self_confidence_kd_loss(s, t, y, c, 0.35,
                                                            1.0),
               lambda s, t, y, c: JD.self_confidence_kd_loss(s, t, y, c, 0.35,
                                                             1.0),
               s, t, y, counts)


def test_masked_self_confidence_kd_loss():
    s, t, y, _ = kd_inputs(4, 40, 33)
    counts = np.random.RandomState(4).randint(1, 30, 33).astype(np.float32)
    mask = (np.random.RandomState(5).uniform(size=40) > 0.3).astype(
        np.float32)
    check_loss(lambda s, t, y, c, m: D.masked_self_confidence_kd_loss(
                   s, t, y, c, 0.5, 2.0, m),
               lambda s, t, y, c, m: JD.masked_self_confidence_kd_loss(
                   s, t, y, c, 0.5, 2.0, m),
               s, t, y, counts, mask)


def test_iid_client_reduces_to_cross_entropy():
    """The paper's adaptivity claim: a balanced client has ρ = 1, the
    target is one-hot, and at τ = 1 the KD term is the CE — in the port as
    in the reference."""
    s, t, y, _ = kd_inputs(2, 16, 10)
    counts = np.full(10, 100.0, np.float32)
    loss, aux = D.self_confidence_kd_loss(*th(s, t, y, counts), 0.35, 1.0)
    np.testing.assert_allclose(float(loss), float(aux["ce"]), rtol=1e-4)
    jloss, _ = JD.self_confidence_kd_loss(s, t, y, counts, 0.35, 1.0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tgt = D.self_confidence_targets(torch.from_numpy(t), torch.from_numpy(y),
                                    torch.ones(10), 1.0)
    np.testing.assert_allclose(tgt.numpy(), np.eye(10)[y], atol=1e-6)


def test_targets_and_confidence():
    s, t, y, rho = kd_inputs(0, 16, 10)
    tgt = D.self_confidence_targets(*th(t, y, rho), 1.5)
    want = JD.self_confidence_targets(t, y, rho, 1.5)
    np.testing.assert_allclose(tgt.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgt.sum(-1).numpy(), 1.0, rtol=1e-5)
    counts = np.array([10.0, 40.0, 0.0, 20.0], np.float32)
    np.testing.assert_allclose(D.class_confidence(torch.from_numpy(counts)),
                               [0.25, 1.0, 0.0, 0.5])
    np.testing.assert_allclose(D.softmax_T(torch.from_numpy(s), 2.0).numpy(),
                               JD.softmax_T(s, 2.0), rtol=1e-5, atol=1e-7)


def test_kl_loss():
    s, t, _, _ = kd_inputs(5, 16, 10)
    p = np.asarray(JD.softmax_T(t, 1.0))
    check_loss(lambda s, p: D.kl_loss(s, p, 2.0),
               lambda s, p: JD.kl_loss(s, p, 2.0), s, p)


def test_fedgkd_loss():
    s, t, y, _ = kd_inputs(8, 32, 10)
    check_loss(lambda s, t, y: D.fedgkd_loss(s, t, y, 0.1, 0.5),
               lambda s, t, y: JD.fedgkd_loss(s, t, y, 0.1, 0.5), s, t, y)


def test_fedntd_loss():
    s, t, y, _ = kd_inputs(9, 32, 10)
    check_loss(lambda s, t, y: D.fedntd_loss(s, t, y, 0.3, 1.0),
               lambda s, t, y: JD.fedntd_loss(s, t, y, 0.3, 1.0), s, t, y)


def test_fedrs_cross_entropy():
    s, _, y, _ = kd_inputs(10, 32, 10)
    present = np.zeros(10, np.float32)
    present[[0, 3, 4]] = 1.0
    check_loss(lambda s, y, p: D.cross_entropy(D.fedrs_logits(s, p, 0.5), y),
               lambda s, y, p: JD.cross_entropy(JD.fedrs_logits(s, p, 0.5),
                                                y),
               s, y, present)


def test_moon_loss():
    rng = np.random.RandomState(12)
    z, zg, zp = (rng.randn(32, 128).astype(np.float32) for _ in range(3))
    check_loss(lambda z, zg, zp: D.moon_loss(z, zg, zp, 1.0, 0.5),
               lambda z, zg, zp: JD.moon_loss(z, zg, zp, 1.0, 0.5),
               z, zg, zp)
