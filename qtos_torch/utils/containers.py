"""Bounded host-side containers used by the replan/visual layers (own copy
of `qtos_tpu.utils.containers`).

Functional parity with the reference's container utilities
(reference: QTOS/containers.py — ``LimitedFIFOQueue`` :5 windowed average,
``FIFOQueue`` :74, ``Limited_Stack`` :128 bounded LIFO of (start, goal)
plans).  These live on the host side of the stack only: device-side
trajectory buffering is the on-device table and its slice-assignment
stitching in ``qtos_torch.control.replan``.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class LimitedFIFOQueue:
    """FIFO with a size bound and a windowed average (used by the reference
    for plan-vs-robot error smoothing — QTOS/planner.py:96-137)."""

    def __init__(self, max_size: int):
        self._q: deque = deque(maxlen=max_size)
        self.max_size = max_size

    def enqueue(self, item) -> None:
        self._q.append(item)

    def dequeue(self):
        if not self._q:
            raise IndexError("queue is empty")
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def average(self) -> float:
        if not self._q:
            return 0.0
        return float(sum(self._q) / len(self._q))


class FIFOQueue:
    """Unbounded FIFO (the reference scrolls visual-plan marker ids through
    one — QTOS/visual.py:54-86)."""

    def __init__(self):
        self._q: deque = deque()

    def enqueue(self, item) -> None:
        self._q.append(item)

    def dequeue(self):
        if self.is_empty():
            raise IndexError("queue is empty")
        return self._q.popleft()

    def is_empty(self) -> bool:
        return len(self._q) == 0

    def size(self) -> int:
        return len(self._q)

    def __len__(self) -> int:
        return len(self._q)


class LimitedStack:
    """Bounded LIFO of (start, goal) plan pairs; oldest entries fall off the
    bottom (reference: QTOS/containers.py:128-218, used by
    Global_Planner.update to retain recent local-solve endpoints)."""

    def __init__(self, max_size: int = 10):
        self.max_size = max_size
        self._s: deque = deque(maxlen=max_size)

    def push(self, item) -> None:
        # normalize array pairs to plain lists, matching the reference's
        # (start, goal) storage contract
        if (
            isinstance(item, tuple)
            and len(item) == 2
            and (isinstance(item[0], np.ndarray) or isinstance(item[1], np.ndarray))
        ):
            item = (np.asarray(item[0]).tolist(), np.asarray(item[1]).tolist())
        self._s.append(item)

    def pop(self):
        if self.is_empty():
            raise IndexError("stack is empty")
        return self._s.pop()

    def peek(self):
        if self.is_empty():
            raise IndexError("stack is empty")
        return self._s[-1]

    def is_empty(self) -> bool:
        return len(self._s) == 0

    def size(self) -> int:
        return len(self._s)

    def clear(self) -> None:
        self._s.clear()


# reference-spelled alias (QTOS/containers.py:128)
Limited_Stack = LimitedStack
