"""Small functional helpers.

The reference leans on cytoolz (first/second/partition_all/take/thread_last,
e.g. ccdc/core.py:25-32); these are the handful actually needed, dependency
free.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T")


def first(xs: Sequence[T]) -> T:
    return next(iter(xs))


def second(xs: Sequence[T]) -> T:
    it = iter(xs)
    next(it)
    return next(it)


def take(n: int, xs: Iterable[T]) -> Iterator[T]:
    return itertools.islice(xs, n)


def partition_all(n: int, xs: Iterable[T]) -> Iterator[tuple[T, ...]]:
    """Partition xs into tuples of length n (last may be shorter).

    Same semantics as cytoolz.partition_all used for driver chunking
    (ccdc/core.py:98-99).
    """
    it = iter(xs)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def flatten(xs: Iterable[Iterable[T]]) -> Iterator[T]:
    for x in xs:
        yield from x
