"""Union-find (disjoint sets) with union-by-size and path compression.

Host-side track merging primitive, a copy of `opensfm_tpu.unionfind`
(reference: opensfm/unionfind.py:50,
foundation/union_find.h).  Used to fuse pairwise feature matches into
multi-view tracks.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List


class UnionFind:
    """Disjoint-set forest over arbitrary hashable items."""

    def __init__(self) -> None:
        self._parent: Dict[Hashable, Hashable] = {}
        self._size: Dict[Hashable, int] = {}

    def add(self, item: Hashable) -> None:
        if item not in self._parent:
            self._parent[item] = item
            self._size[item] = 1

    def find(self, item: Hashable) -> Hashable:
        self.add(item)
        root = item
        while self._parent[root] != root:
            root = self._parent[root]
        # Path compression.
        while self._parent[item] != root:
            self._parent[item], item = root, self._parent[item]
        return root

    def union(self, a: Hashable, b: Hashable) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self._size[ra] < self._size[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._size[ra] += self._size[rb]

    def items(self) -> Iterable[Hashable]:
        return self._parent.keys()

    def clusters(self) -> List[List[Hashable]]:
        """All connected components, each as a list of items."""
        groups: Dict[Hashable, List[Hashable]] = {}
        for item in self._parent:
            groups.setdefault(self.find(item), []).append(item)
        return list(groups.values())
