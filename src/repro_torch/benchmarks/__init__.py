"""The paper's benchmark drivers on the port (counterpart of the
repository's top-level ``benchmarks/``, module for module): the figure and
table drivers over ``common.run_fl``, the straggler, fleet, comm-load and
serving benchmarks, and the ``run`` harness.

Importing a module here runs nothing: each driver's ``main`` runs only when
called or under ``python -m``.
"""
