"""The port's head calibration (Sec. IV-D) against the JAX package's, on the
same numpy data and the reference's own CNN init (width 8, 16x16 images).

Bars: after ten calibration steps the personalised head is within 1e-5 of
each leaf's scale of the reference's (the one-round bar of
``test_torch_simulator.py``, here over ten SGD steps of one layer), every
other leaf
is untouched, and the mean personalised accuracy over three clients
equals the reference's within 0.02.

The batches are drawn at ``seed=0``, the functions' default.  At seed 3
the proximal run (μ = 0.5) is on a sensitive trajectory: the port against
itself, with its parameters perturbed by 1e-7 relative, ends 2.0e-5 of the
bias's scale apart, as far as it ends from the reference (2.2e-5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.personalization import calibrate_head as j_calibrate
from repro.core.personalization import personalized_accuracy as j_accuracy
from repro.data.partition import class_counts, dirichlet_partition
from repro.data.synthetic import make_image_dataset
from repro.models.vision import cnn_apply as j_apply
from repro.models.vision import cnn_init as j_init
from repro_torch import convert
from repro_torch.core.personalization import (calibrate_head,
                                              personalized_accuracy)
from repro_torch.models.vision import cnn_apply


@pytest.fixture(scope="module")
def setup():
    x, y, xt, yt = make_image_dataset(600, 200, 10, image_size=16, seed=0,
                                      noise=0.5)
    parts = dirichlet_partition(y, 6, alpha=0.3, seed=0)
    jparams = jax.tree.map(np.asarray,
                           j_init(jax.random.PRNGKey(0), 10, width=8,
                                  image_size=16))
    return x, y, xt, yt, parts, jparams


@pytest.mark.parametrize("reg", ["none", "prox", "kd"])
def test_calibrate_head_matches_reference(setup, reg):
    x, y, _, _, parts, jparams = setup
    counts = class_counts(y, parts, 10)
    p = parts[1]
    kw = dict(steps=10, batch_size=32, eta=0.05, reg=reg, mu=0.5, lam=0.35,
              tau=1.5, seed=0)
    want = j_calibrate(jax.tree.map(jnp.asarray, jparams), j_apply, "head",
                       x[p], y[p], jnp.asarray(counts[1]), **kw)
    got = calibrate_head(convert.from_numpy(jparams, "cpu"), cnn_apply,
                         "head", x[p], y[p], torch.from_numpy(counts[1]),
                         **kw)
    got_np = convert.to_numpy(got)
    for key in jparams:
        for g, w, w0 in zip(jax.tree.leaves(got_np[key]),
                            jax.tree.leaves(want[key]),
                            jax.tree.leaves(jparams[key])):
            w = np.asarray(w)
            if key != "head":
                np.testing.assert_array_equal(g, w0)
                continue
            assert not np.array_equal(g, w0)
            scale = np.abs(w).max()
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-5,
                                       rtol=0)


def test_personalized_accuracy_matches_reference(setup):
    x, y, xt, yt, parts, jparams = setup
    counts = class_counts(y, parts, 10)
    train = [(x[p], y[p]) for p in parts[:3]]
    test = []
    for p in parts[:3]:
        mask = np.isin(yt, np.unique(y[p]))
        test.append((xt[mask], yt[mask]))
    kw = dict(steps=5, batch_size=32, eta=0.05, reg="kd")
    want = j_accuracy(jax.tree.map(jnp.asarray, jparams),
                      functools.partial(j_apply), "head", train, test,
                      counts[:3], **kw)
    got = personalized_accuracy(convert.from_numpy(jparams, "cpu"), cnn_apply,
                                "head", train, test, counts[:3], **kw)
    assert 0.0 <= got <= 1.0
    assert abs(got - want) <= 0.02
