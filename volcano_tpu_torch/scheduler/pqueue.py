"""Binary-heap priority queue over a less-function.

The port's copy of ``volcano_tpu/scheduler/pqueue.py``: comparisons call
the less fn lazily at sift time, so if the ordering keys mutate while
items sit in the queue (DRF/proportion shares do), pop order reflects heap
structure rather than a full re-sort, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, List


class PriorityQueue:
    def __init__(self, less: Callable[[Any, Any], bool]):
        self._less = less
        self._items: List[Any] = []

    def __len__(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def push(self, item: Any) -> None:
        self._items.append(item)
        self._sift_up(len(self._items) - 1)

    def pop(self) -> Any:
        items = self._items
        last = len(items) - 1
        items[0], items[last] = items[last], items[0]
        out = items.pop()
        if items:
            self._sift_down(0)
        return out

    def _sift_up(self, i: int) -> None:
        items, less = self._items, self._less
        while i > 0:
            parent = (i - 1) // 2
            if not less(items[i], items[parent]):
                break
            items[i], items[parent] = items[parent], items[i]
            i = parent

    def _sift_down(self, i: int) -> None:
        items, less = self._items, self._less
        n = len(items)
        while True:
            left, right = 2 * i + 1, 2 * i + 2
            smallest = i
            if left < n and less(items[left], items[smallest]):
                smallest = left
            if right < n and less(items[right], items[smallest]):
                smallest = right
            if smallest == i:
                return
            items[i], items[smallest] = items[smallest], items[i]
            i = smallest
