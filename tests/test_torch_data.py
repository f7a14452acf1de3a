"""The port's numpy copies of the data and selection modules give the same
arrays and the same picks as the JAX package's from the same seed."""
import numpy as np
import pytest

from repro.core import selection as jsel
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.core import selection as sel
from repro_torch.data import partition as part
from repro_torch.data import synthetic as syn


@pytest.fixture(scope="module")
def dataset():
    return syn.make_image_dataset(600, 100, 10, image_size=16, noise=0.5,
                                  seed=3)


def test_make_image_dataset(dataset):
    want = jsyn.make_image_dataset(600, 100, 10, image_size=16, noise=0.5,
                                   seed=3)
    for a, b in zip(dataset, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,arg", [("sort_and_partition", 2),
                                    ("dirichlet_partition", 0.3)])
def test_partitions(dataset, fn, arg):
    y = dataset[1]
    got = getattr(part, fn)(y, 12, arg, seed=5)
    want = getattr(jpart, fn)(y, 12, arg, seed=5)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(part.class_counts(y, got, 10),
                                  jpart.class_counts(y, want, 10))


@pytest.mark.parametrize("name", ["random", "class_coverage"])
def test_selection(dataset, name):
    y = dataset[1]
    parts = jpart.sort_and_partition(y, 20, 1, seed=0)
    counts = jpart.class_counts(y, parts, 10)
    rng_a, rng_b = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(5):
        args = (20, 4) if name == "random" else (20, 4, counts)
        np.testing.assert_array_equal(sel.SELECTORS[name](rng_a, *args),
                                      jsel.SELECTORS[name](rng_b, *args))
