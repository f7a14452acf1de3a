"""Entry-point steps (counterpart of the JAX package's ``launch/``); this
slice has the serving steps."""
