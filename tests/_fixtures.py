"""Module-scoped fixtures for the port's parity test files; import one into
a test module to apply it there (both are autouse).

* ``one_torch_thread``: one torch thread while the module runs.  Its
  tensors are small (a width-8 CNN, reduced LMs), so one thread runs them
  as fast as eight, and torch's idle workers stop contending with the
  reference's XLA thread pool in the same process.
* ``shared_reference_jits``: the reference's engines jit their round,
  broadcast and eval functions (the async engine also its deltas and apply
  functions) per instance, so every engine a test builds traces and
  compiles them anew.  Engines built from the same configs, the run length
  and seed aside, trace the same functions: each one after the first takes
  the first one's jitted functions, and with them the executables already
  compiled.  The eval function reads only the model, so it is shared by
  every engine of one model.  Engines given telemetry, a scheduler or a
  store keep their own.
"""
from dataclasses import replace

import pytest
import torch

from repro.federated.async_engine import AsyncFederatedSimulator as JAsync
from repro.federated.simulator import FederatedSimulator as JSim

_PER_CONFIG = ("_round_fn", "_bcast_fn", "_deltas_fn", "_apply_fn")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def shared_reference_jits():
    cache = {}

    def sharing(init):
        def __init__(self, fed, sim, *args, **kw):
            init(self, fed, sim, *args, **kw)
            if type(self).__init__ is not __init__ or len(args) > 5 or kw:
                return            # a subclass's __init__ is still running,
                # or telemetry, a scheduler or a store may change the trace
            parts = args[4]
            model = ("eval", sim.model, sim.n_classes, sim.cnn_width)
            config = (type(self), repr(fed), len(parts),
                      repr(replace(sim, rounds=1, eval_every=1, seed=0)))
            for key, names in ((model, ("_eval_fn",)), (config, _PER_CONFIG)):
                fns = cache.setdefault(key, {n: getattr(self, n) for n in names
                                             if hasattr(self, n)})
                for n, fn in fns.items():
                    setattr(self, n, fn)
        return __init__

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSim, "__init__", sharing(JSim.__init__))
        mp.setattr(JAsync, "__init__", sharing(JAsync.__init__))
        yield
