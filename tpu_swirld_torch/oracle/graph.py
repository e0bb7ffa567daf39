"""Graph utilities over the hash-linked event DAG (copy of the reference's
``tpu_swirld/oracle/graph.py``): ``bfs``, ``dfs`` and ``toposort``, written
iteratively (no recursion limits) and deterministic: neighbors are visited in
the order the successor function yields them.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, TypeVar

T = TypeVar("T")


def bfs(starts: Iterable[T], succ: Callable[[T], Iterable[T]]) -> Iterator[T]:
    """Breadth-first traversal from ``starts``; yields each node once."""
    seen = set()
    queue: List[T] = []
    for s in starts:
        if s not in seen:
            seen.add(s)
            queue.append(s)
    i = 0
    while i < len(queue):
        node = queue[i]
        i += 1
        yield node
        for nxt in succ(node):
            if nxt not in seen:
                seen.add(nxt)
                queue.append(nxt)


def dfs(starts: Iterable[T], succ: Callable[[T], Iterable[T]]) -> Iterator[T]:
    """Iterative depth-first traversal; yields each node once (preorder)."""
    seen = set()
    stack = list(starts)[::-1]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        yield node
        children = list(succ(node))
        for nxt in reversed(children):
            if nxt not in seen:
                stack.append(nxt)


def toposort(nodes: Iterable[T], parents: Callable[[T], Iterable[T]]) -> List[T]:
    """Topological order (parents before children) of ``nodes``.

    Only nodes in ``nodes`` are ordered; parents outside the set are assumed
    already present downstream and are skipped.  Deterministic for a fixed
    input order.  Iterative post-order DFS.
    """
    node_set = set(nodes)
    out: List[T] = []
    done = set()
    in_progress = set()
    for root in nodes:
        if root in done:
            continue
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if node in done:
                continue
            if expanded:
                in_progress.discard(node)
                done.add(node)
                out.append(node)
                continue
            if node in in_progress:
                raise ValueError("cycle detected in event graph")
            in_progress.add(node)
            stack.append((node, True))
            for par in parents(node):
                if par in node_set and par not in done:
                    stack.append((par, False))
    return out
