"""Vectorized residue engine: the object sub-cycle's allocate pass over
the node axis in numpy (the port's copy of
``volcano_tpu/scheduler/residue.py``).

The fast cycle leaves to its object sub-cycle the jobs the device solves
cannot express: intern-cap overflow, volume shapes the count model cannot
hold, best-effort pods of dynamic jobs.  This engine runs their allocate
pass: the same queue/job/task loop as ``AllocateAction._execute_host``
(``allocate_loop``), with the per-task inner step batched over the nodes:

  * resource fit follows ``Resource.less_equal`` op for op on [N, R] f64
    columns (strict less, or an absolute difference under epsilon, per
    dimension);
  * the static predicates (ready, unschedulable, pressure, selector,
    required node affinity, taints) come from one cached [N] mask per task
    class, built by ``snapshot.static_predicate_task``;
  * host ports and pod (anti)affinity read per-node resident port sets and
    per-selector match-count columns, built in one sweep over the
    residents and updated as the pass places tasks;
  * volume claims resolve through the session ``VolumeBinder``'s own state
    (its assumptions included) into [N] masks;
  * the scores follow the nodeorder plugin expression for expression in
    f64, so the argmax (first max in node order) picks the node the
    per-task loop picks.

The engine is bit for bit the per-task loop: ``tests/test_torch_residue.py``
holds both, and the JAX engine, equal on seeded mixed clusters (binds,
statuses and fit-error histograms).  When a head task has no feasible node
the engine re-runs that one task through ``util.predicate_nodes``, so the
reason histogram is the loop's.

It serves only filtered passes (``job_filter`` set); the unfiltered pass
keeps the per-task loop as the oracle.  A predicate or score chain the
engine does not model keeps the loop too.  This is host code: the JAX
package runs it in numpy on the host as well, with no device program.
"""

from __future__ import annotations

import time
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU, MIN_SCALAR
from volcano_tpu_torch.scheduler import util
from volcano_tpu_torch.scheduler.cache import VolumeBindingError


def _active_fns(ssn, registry, flag):
    """Plugin names the session's tier dispatch would call."""
    return [plugin.name for _, plugin, _ in ssn._ordered(registry, flag)]


def chain_known(ssn) -> bool:
    """Whether the session's predicate and score chains are exactly those
    this engine models (the predicates plugin once, the nodeorder plugin at
    most once).  Anything else keeps the per-task loop."""
    preds = _active_fns(ssn, ssn.predicate_fns, "enabled_predicate")
    if preds not in ([], ["predicates"]):
        return False
    orders = _active_fns(ssn, ssn.node_order_fns, "enabled_node_order")
    return orders in ([], ["nodeorder"])


def _nodeorder_weights(ssn) -> Tuple[float, float, float, float]:
    from volcano_tpu_torch.scheduler.conf import get_plugin_arg

    for tier in ssn.tiers:
        for opt in tier.plugins:
            if opt.name == "nodeorder":
                args = opt.arguments
                return (
                    get_plugin_arg(args, "leastrequested.weight", 1.0),
                    get_plugin_arg(args, "balancedresource.weight", 1.0),
                    get_plugin_arg(args, "nodeaffinity.weight", 1.0),
                    get_plugin_arg(args, "podaffinity.weight", 1.0),
                )
    return 0.0, 0.0, 0.0, 0.0


class _Engine:
    """A pass's node-axis state.  Every float column is f64 and every
    update replays the per-task loop's arithmetic in its order, so scores
    and epsilon fits are the loop's to the bit."""

    def __init__(self, ssn):
        self.ssn = ssn
        self.nodes: List = util.get_node_list(ssn.nodes)
        self.n = len(self.nodes)
        self.scoring = bool(_active_fns(ssn, ssn.node_order_fns, "enabled_node_order"))
        # without the predicates plugin the loop filters on resource fit
        # alone, and so does the engine
        self.predicates_on = bool(_active_fns(ssn, ssn.predicate_fns, "enabled_predicate"))
        self.w_least, self.w_bal, self.w_aff, self.w_pod = (
            _nodeorder_weights(ssn) if self.scoring else (0.0,) * 4)
        # resource dims: cpu, memory and every scalar a node knows; a task
        # scalar outside them takes the per-task fallback
        scalars = set()
        for ni in self.nodes:
            scalars.update(ni.idle.scalars)
            scalars.update(ni.releasing.scalars)
            scalars.update(ni.used.scalars)
            scalars.update(ni.allocatable.scalars)
        self.dims = ["cpu", "memory", *sorted(scalars)]
        self.dimset = set(self.dims)
        R = len(self.dims)
        self.eps = np.array([MIN_MILLI_CPU, MIN_MEMORY] + [MIN_SCALAR] * (R - 2), np.float64)
        self.idle = np.zeros((self.n, R), np.float64)
        self.releasing = np.zeros((self.n, R), np.float64)
        self.used2 = np.zeros((self.n, 2), np.float64)   # cpu, memory (scores)
        self.cap2 = np.zeros((self.n, 2), np.float64)
        self.counts = np.zeros(self.n, np.int64)
        self.max_tasks = np.full(self.n, np.iinfo(np.int64).max, np.int64)
        for i, ni in enumerate(self.nodes):
            self._vec(ni.idle, self.idle[i])
            self._vec(ni.releasing, self.releasing[i])
            self.used2[i, 0] = ni.used.milli_cpu
            self.used2[i, 1] = ni.used.memory
            self.cap2[i, 0] = ni.allocatable.milli_cpu
            self.cap2[i, 1] = ni.allocatable.memory
            self.counts[i] = len(ni.tasks)
            if ni.allocatable.max_task_num is not None:
                self.max_tasks[i] = ni.allocatable.max_task_num
        self.node_index = {ni.name: i for i, ni in enumerate(self.nodes)}
        # lazy per-class static masks and node-affinity score columns
        self._class_cache: Dict[object, Tuple[np.ndarray, np.ndarray]] = {}
        # lazy resident port sets and selector count columns
        self._port_sets: Optional[List[set]] = None
        self._port_masks: Dict[FrozenSet[int], np.ndarray] = {}
        self._sel_counts: Dict[tuple, np.ndarray] = {}
        # volume node masks per affinity signature
        self._aff_masks: Dict[tuple, np.ndarray] = {}
        self._labels: Optional[List[dict]] = None

    def _vec(self, res, out) -> None:
        out[0] = res.milli_cpu
        out[1] = res.memory
        for i, name in enumerate(self.dims[2:], start=2):
            out[i] = res.scalars.get(name, 0.0)

    # -- fit (Resource.less_equal, op for op) ----------------------------------

    def _fits(self, req_vec: np.ndarray, pool: np.ndarray) -> np.ndarray:
        return np.all(
            (req_vec[None, :] < pool) | (np.abs(pool - req_vec[None, :]) < self.eps[None, :]),
            axis=1)

    # -- static predicate class columns ----------------------------------------

    def _class_cols(self, task) -> Tuple[np.ndarray, np.ndarray]:
        from volcano_tpu_torch.scheduler.plugins.nodeorder import node_affinity_score
        from volcano_tpu_torch.scheduler.snapshot import static_predicate_task, task_class_key

        key = task_class_key(task)
        hit = self._class_cache.get(key)
        if hit is not None:
            return hit
        mask = np.zeros(self.n, bool)
        aff = np.zeros(self.n, np.float64)
        for i, ni in enumerate(self.nodes):
            mask[i] = static_predicate_task(task, ni)
            if self.scoring:
                # every node: with the predicates plugin off the loop
                # scores every fitting node, masked or not
                aff[i] = node_affinity_score(task, ni)
        self._class_cache[key] = (mask, aff)
        return mask, aff

    # -- resident ports and selector counts ------------------------------------

    def _ensure_residents(self) -> None:
        if self._port_sets is not None:
            return
        self._port_sets = [set() for _ in range(self.n)]
        self._resident_labels: List[List[dict]] = [[] for _ in range(self.n)]
        for i, ni in enumerate(self.nodes):
            ps = self._port_sets[i]
            rl = self._resident_labels[i]
            for t in ni.tasks.values():
                ps.update(t.pod.spec.host_ports)
                rl.append(t.pod.meta.labels)

    def _ports_mask(self, ports: FrozenSet[int]) -> np.ndarray:
        mask = self._port_masks.get(ports)
        if mask is None:
            self._ensure_residents()
            mask = np.fromiter((not (ports & s) for s in self._port_sets), bool, count=self.n)
            self._port_masks[ports] = mask
        return mask

    def _sel_col(self, sel_items: tuple) -> np.ndarray:
        col = self._sel_counts.get(sel_items)
        if col is None:
            self._ensure_residents()
            col = np.zeros(self.n, np.float64)
            for i, labels_list in enumerate(self._resident_labels):
                c = 0
                for labels in labels_list:
                    if all(labels.get(k) == v for k, v in sel_items):
                        c += 1
                col[i] = c
            self._sel_counts[sel_items] = col
        return col

    # -- volumes (VolumeBinder._resolve_claim over the node axis) --------------

    def _node_labels(self) -> List[dict]:
        if self._labels is None:
            self._labels = [ni.node.labels for ni in self.nodes]
        return self._labels

    def _affinity_mask(self, affinity: Dict[str, str]) -> np.ndarray:
        if not affinity:
            return np.ones(self.n, bool)
        key = tuple(sorted(affinity.items()))
        mask = self._aff_masks.get(key)
        if mask is None:
            labels = self._node_labels()
            mask = np.fromiter(
                (all(labels[i].get(k) == v for k, v in affinity.items()) for i in range(self.n)),
                bool, count=self.n)
            self._aff_masks[key] = mask
        return mask

    def _volume_mask(self, task) -> Optional[np.ndarray]:
        """AND over the task's pending claims of the nodes where
        ``_resolve_claim`` would pass; built afresh a task, since the
        binder's assumptions move as the pass places siblings."""
        vb = getattr(self.ssn.cache, "volume_binder", None)
        if vb is None or task.pod is None or not task.pod.volumes:
            return None
        claims = vb._pending_claims(task.pod)
        if not claims:
            return None
        mask = np.ones(self.n, bool)
        for pvc in claims:
            assumed = vb._claim_assumed.get(pvc.meta.key)
            if pvc.volume_name or assumed:
                pv = vb._pv(pvc.volume_name or assumed)
                if pv is None:
                    return np.zeros(self.n, bool)
                if pv.node_affinity:
                    mask = mask & self._affinity_mask(pv.node_affinity)
            elif vb._is_static_class(pvc.storage_class):
                want = vb._qty(pvc.size) if pvc.size else 0.0
                claim_mask = np.zeros(self.n, bool)
                for pv in vb._pvs():
                    if pv.claim_ref or pv.meta.name in vb._assumed_pvs:
                        continue
                    if pv.storage_class != pvc.storage_class:
                        continue
                    cap = vb._qty(pv.capacity) if pv.capacity else float("inf")
                    if cap < want:
                        continue
                    claim_mask = claim_mask | self._affinity_mask(pv.node_affinity)
                    if claim_mask.all():
                        break
                mask = mask & claim_mask
            # a pending claim of a dynamic class fits everywhere
            if not mask.any():
                break
        return mask

    # -- the per-task step -----------------------------------------------------

    def place(self, task):
        """(node_info, use_idle) for the node the per-task loop picks, None
        when no node is feasible, or "fallback" for a request shape outside
        the engine's dims (the caller runs the loop's step)."""
        req = task.init_resreq
        if not set(req.scalars) <= self.dimset:
            return "fallback"
        req_vec = np.zeros(len(self.dims), np.float64)
        self._vec(req, req_vec)
        fit_idle = self._fits(req_vec, self.idle)
        fit_rel = self._fits(req_vec, self.releasing)
        feasible = fit_idle | fit_rel
        if not feasible.any():
            return None
        static_mask, aff_col = self._class_cols(task)
        spec = task.pod.spec
        aff = spec.affinity
        sel_req = sel_anti = ()
        if aff is not None:
            sel_req = [tuple(sorted(s.items())) for s in aff.pod_affinity]
            sel_anti = [tuple(sorted(s.items())) for s in aff.pod_anti_affinity]
        if self.predicates_on:
            feasible &= static_mask
            feasible &= self.counts + 1 <= self.max_tasks
            if spec.host_ports:
                feasible &= self._ports_mask(frozenset(spec.host_ports))
            for s in sel_req:
                feasible &= self._sel_col(s) > 0
            for s in sel_anti:
                feasible &= self._sel_col(s) == 0
            vol_mask = self._volume_mask(task)
            if vol_mask is not None:
                feasible &= vol_mask
        if not feasible.any():
            return None
        if self.scoring:
            score = self._score(task, aff_col, sel_req, sel_anti)
        else:
            score = np.zeros(self.n, np.float64)
        score = np.where(feasible, score, -np.inf)
        i = int(np.argmax(score))  # first max, as util.select_best_node
        return self.nodes[i], bool(fit_idle[i])

    def _score(self, task, aff_col, sel_req, sel_anti) -> np.ndarray:
        # the nodeorder plugin's formulas, expression for expression in f64
        rr = task.resreq
        cap_cpu, cap_mem = self.cap2[:, 0], self.cap2[:, 1]
        used_cpu = self.used2[:, 0] + rr.milli_cpu
        used_mem = self.used2[:, 1] + rr.memory
        with np.errstate(divide="ignore", invalid="ignore"):
            t_cpu = np.where(cap_cpu > 0,
                             np.maximum(0.0, cap_cpu - used_cpu) * 10.0 / cap_cpu, 0.0)
            t_mem = np.where(cap_mem > 0,
                             np.maximum(0.0, cap_mem - used_mem) * 10.0 / cap_mem, 0.0)
            least = (t_cpu + t_mem) / 2.0
            cpu_frac = used_cpu / cap_cpu
            mem_frac = used_mem / cap_mem
        balanced = np.where(
            (cap_cpu > 0) & (cap_mem > 0) & (cpu_frac < 1.0) & (mem_frac < 1.0),
            10.0 - np.abs(cpu_frac - mem_frac) * 10.0,
            0.0)
        score = self.w_least * least
        score = score + self.w_bal * balanced
        score = score + self.w_aff * aff_col
        if sel_req or sel_anti:
            inter = np.zeros(self.n, np.float64)
            for s in sel_req:
                inter = inter + self._sel_col(s)
            for s in sel_anti:
                inter = inter - self._sel_col(s)
            score = score + self.w_pod * inter
        return score

    # -- bookkeeping after a placement -----------------------------------------

    def account(self, task, node_name: str, use_idle: bool) -> None:
        """``NodeInfo.add_task``'s effect on the engine's columns (the
        session's objects were updated by ssn.allocate / ssn.pipeline)."""
        i = self.node_index[node_name]
        rr = np.zeros(len(self.dims), np.float64)
        self._vec(task.resreq, rr)
        if use_idle:
            self.idle[i] = np.maximum(self.idle[i] - rr, 0.0)
        else:
            self.releasing[i] = np.maximum(self.releasing[i] - rr, 0.0)
        self.used2[i, 0] += task.resreq.milli_cpu
        self.used2[i, 1] += task.resreq.memory
        self.counts[i] += 1
        # the resident ports and selectors follow the placement, so later
        # tasks see this pass's pods, as the loop walking node.tasks does
        spec = task.pod.spec
        if spec.host_ports and self._port_sets is not None:
            placed = set(spec.host_ports)
            self._port_sets[i].update(placed)
            for pset, mask in self._port_masks.items():
                if pset & placed:
                    mask[i] = False
        labels = task.pod.meta.labels
        if self._port_sets is not None:
            self._resident_labels[i].append(labels)
        for sel_items, col in self._sel_counts.items():
            if all(labels.get(k) == v for k, v in sel_items):
                col[i] += 1


def vector_allocate(ssn, job_filter, stats: Optional[dict] = None) -> bool:
    """The residue allocate pass with the batched inner step, driven by the
    same ``allocate_loop`` as the per-task loop.  Returns False, having
    done nothing, when the session's chains are not the known set; the
    caller then runs the per-task loop.  ``stats`` gathers {"tasks",
    "seconds"}."""
    from volcano_tpu_torch.scheduler.actions.allocate import (
        allocate_loop,
        fit_first_predicate_fn,
    )

    if not chain_known(ssn):
        return False
    t0 = time.perf_counter()
    engine = _Engine(ssn)
    all_nodes = engine.nodes
    counter = [0]
    # the per-node check of the loop, paid only for unschedulable heads
    predicate_fn = fit_first_predicate_fn(ssn)

    def inner(job, task) -> bool:
        counter[0] += 1
        verdict = engine.place(task)
        if verdict == "fallback":
            # a request shape outside the engine's dims: the loop's step
            # decides over the same session state the engine mirrors
            reasons: dict = {}
            feasible = util.predicate_nodes(task, all_nodes, predicate_fn, reasons)
            if feasible:
                scores = util.prioritize_nodes(task, feasible, ssn.node_order_fn)
                node = util.select_best_node(scores)
                verdict = (node, task.init_resreq.less_equal(node.idle))
            else:
                verdict = None
                job.fit_errors = reasons
        if verdict is None:
            # an unschedulable head: its reason histogram is the loop's,
            # from one predicate sweep of this task (unless the fallback
            # above made it)
            if not job.fit_errors:
                reasons = {}
                util.predicate_nodes(task, all_nodes, predicate_fn, reasons)
                job.fit_errors = reasons
            job.fit_total_nodes = len(all_nodes)
            return False

        node, use_idle = verdict
        if use_idle:
            try:
                ssn.allocate(task, node.name)
                engine.account(task, node.name, True)
            except VolumeBindingError:
                # a sibling took the volume between predicate and allocate:
                # the task stays pending, as in the loop
                pass
        else:
            delta = node.idle.clone()
            delta.fit_delta(task.init_resreq)
            job.nodes_fit_delta[node.name] = delta
            job.fit_total_nodes = len(all_nodes)
            ssn.pipeline(task, node.name)
            engine.account(task, node.name, False)
        return True

    allocate_loop(ssn, job_filter, inner)
    if stats is not None:
        stats["tasks"] = stats.get("tasks", 0) + counter[0]
        stats["seconds"] = stats.get("seconds", 0.0) + (time.perf_counter() - t0)
    return True
