"""The ``tiny`` fixture: a temporary checkout of the harness with its
cells cut to tiny sizes (``perfbench_tiny``)."""
from __future__ import annotations

import pytest

from perfbench_tiny import copy_checkout, write_tiny


@pytest.fixture
def tiny(tmp_path):
    root = copy_checkout(tmp_path)
    write_tiny(root)
    return root
