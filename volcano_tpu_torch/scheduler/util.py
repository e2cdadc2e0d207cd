"""Node predicate/prioritize/select helpers (the port's copy of
``volcano_tpu/scheduler/util.py``): straight loops, ties broken on the
first best node in iteration order, so decisions are reproducible."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch.scheduler.model import NodeInfo, TaskInfo


def predicate_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    fn: Callable[[TaskInfo, NodeInfo], Optional[str]],
    reasons: Optional[Dict[str, int]] = None,
) -> List[NodeInfo]:
    """Nodes passing ``fn``.  When ``reasons`` is given, failure messages are
    histogrammed into it (reason -> node count) for JobInfo.fit_error();
    multi-reason messages are "; "-joined by convention and counted per part.
    """
    if reasons is None:
        return [n for n in nodes if fn(task, n) is None]
    feasible = []
    for n in nodes:
        msg = fn(task, n)
        if msg is None:
            feasible.append(n)
        else:
            for part in msg.split("; "):
                reasons[part] = reasons.get(part, 0) + 1
    return feasible


def prioritize_nodes(
    task: TaskInfo, nodes: List[NodeInfo], fn: Callable[[TaskInfo, NodeInfo], float]
) -> Dict[str, Tuple[float, NodeInfo]]:
    return {n.name: (fn(task, n), n) for n in nodes}


def select_best_node(scores: Dict[str, Tuple[float, NodeInfo]]) -> Optional[NodeInfo]:
    best: Optional[NodeInfo] = None
    best_score = float("-inf")
    for _, (score, node) in scores.items():
        if score > best_score:
            best, best_score = node, score
    return best


def sort_nodes(scores: Dict[str, Tuple[float, NodeInfo]]) -> List[NodeInfo]:
    """Nodes by descending score (stable on name for determinism)."""
    return [
        node
        for _, node in sorted(
            scores.values(), key=lambda sn: (-sn[0], sn[1].name)
        )
    ]


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    return list(nodes.values())
