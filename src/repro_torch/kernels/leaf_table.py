"""Pack a leaf table: the host rows a C entry point turns into the
fixed-size structs of ``csrc/leaf_table.cuh``, so that one launch covers
many leaves of a parameter tree.

A row is one leaf: its fields (pointers, counts) followed by the inclusive
ends of its shares of the grid, one end per prefix (blocks, tiles, chunks,
...).  The ends restart from 0 every ``MAX_LEAVES`` leaves, since the C
side builds one struct, and launches once, per group of that many.  Pure
Python over ints.  A wrapper packs a tree's rows once, with placeholder
pointers, and fills a copy with each call's ``data_ptr()``s.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

MAX_LEAVES = 64       # kMaxLeaves in csrc/leaf_table.cuh


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack(fields: Sequence[Sequence[int]], units: Sequence[Sequence[int]],
         capacity: int = MAX_LEAVES) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """``fields[i]`` the ints of leaf i, ``units[i]`` its count of units in
    each prefix -> (the rows, an (n_leaves, columns) int64 matrix: each
    leaf's fields then its ends; per group of ``capacity`` leaves the
    totals of every prefix).  A C entry point takes the matrix by its
    ``.ctypes.data``."""
    flat: List[int] = []
    totals: List[Tuple[int, ...]] = []
    run: List[int] = []
    for i, (f, u) in enumerate(zip(fields, units)):
        if i % capacity:
            run = [r + c for r, c in zip(run, u)]
        else:
            if i:
                totals.append(tuple(run))
            run = list(u)
        flat += f
        flat += run
    if fields:
        totals.append(tuple(run))
    columns = len(flat) // len(fields) if fields else 0
    return np.array(flat, dtype=np.int64).reshape(len(fields), columns), totals


def strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def padded(n: int) -> int:
    """Elements a leaf takes in a sweep's output buffer: rounded up to 8,
    so every leaf's view starts 16-byte aligned in fp32 and bf16."""
    return (n + 7) & ~7
