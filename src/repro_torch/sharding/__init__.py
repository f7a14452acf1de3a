"""Sharding rules of the pod engine, as data (counterpart of the JAX
package's ``sharding/``)."""
