"""Data: the synthetic image dataset and the non-iid client partitioners (numpy copies of the JAX package's ``data/``)."""
