"""The port's CUDA kernels and its cuda backend against their plain
PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips inside its body when
CUDA is unavailable.  The file imports neither jax nor volcano_tpu, so it
also runs on a machine with a card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Decision outputs must be equal; float state is held to rtol=1e-6 (the
sums are exact for these inputs, so bit-equality is expected).
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import kernels as K
from volcano_tpu_torch.scheduler.conf import full_conf
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.scheduler.simargs import add_releasing, build_sim_args

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

DECISIONS = ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps")
POLICIES = [
    dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True, use_proportion=True),
    dict(job_key_order=("drf", "gang", "priority"), use_gang_ready=False, use_proportion=False),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(dev, seed, releasing):
    a = build_sim_args(14, 64, 16, n_queues=3, seed=seed, n_classes=3, class_fill=0.6)
    if releasing:
        add_releasing(a, seed)
    a["node_max_tasks"][:] = 4
    return {k: torch.from_numpy(v).to(dev) for k, v in a.items()}


def _water_fill_inputs(a):
    return (a["queue_weight"], a["queue_request"], a["total"], a["eps"],
            a["queue_participates"])


def _assert_same(out_k, out_p):
    for name in K.SolveOut._fields:
        x, y = getattr(out_k, name), getattr(out_p, name)
        if name in DECISIONS:
            assert torch.equal(x.to(y.dtype), y), name
        else:
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_gpu_water_fill_matches_plain(seed):
    dev = _cuda()
    a = _args(dev, seed, False)
    a["queue_request"][0] *= 0.25
    K.reset_launches()
    des = K.water_fill(*_water_fill_inputs(a))
    assert K.LAUNCHES["water_fill"] == 1
    assert torch.equal(des, K.water_fill_plain(*_water_fill_inputs(a)))


@pytest.mark.gpu
def test_gpu_water_fill_raises_at_round_cap(monkeypatch):
    dev = _cuda()
    a = _args(dev, 0, False)
    a["queue_request"][0] *= 0.25  # one queue capped: needs a second round
    monkeypatch.setattr(K, "WATER_FILL_MAX_ROUNDS", 1)
    with pytest.raises(RuntimeError, match="no convergence"):
        K.water_fill(*_water_fill_inputs(a))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed,releasing", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_gpu_solve_kernel_matches_plain(batch, seed, releasing, policy):
    dev = _cuda()
    a = _args(dev, seed, releasing)
    des = K.water_fill(*_water_fill_inputs(a))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    wrap = K.allocate_solve_batch if batch else K.allocate_solve
    plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
    chunks = dict(m_chunk=4, p_chunk=3) if batch and seed else {}
    K.reset_launches()
    out_k = wrap(*args.values(), 1.0, 1.0, **POLICIES[policy], **chunks)
    assert K.LAUNCHES["allocate_solve_batch" if batch else "allocate_solve"] == 1
    out_p = plain(**args, w_least=1.0, w_balanced=1.0, **POLICIES[policy], **chunks)
    _assert_same(out_k, out_p)
    packed = K.pack_outputs(out_k)
    assert packed.data_ptr() == out_k.task_node.data_ptr()  # the kernel's buffer, no copy
    assert torch.equal(packed, K.pack_outputs(out_p))


def _spec(seed, n_nodes=12, n_jobs=16):
    rng = np.random.default_rng(seed)
    spec = {"queues": [{"name": "qa", "weight": 2}, {"name": "qb", "weight": 1},
                       {"name": "default", "weight": 1}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": {
                "cpu": str(int(rng.choice([4, 8]))),
                "memory": f"{int(rng.choice([8, 16]))}Gi", "pods": 8}}
                for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    if seed == 2:  # a scalar resource as a third dimension
        for node in spec["nodes"]:
            node["allocatable"]["accelerator"] = str(int(rng.integers(0, 3)))
    for j in range(n_jobs):
        n = int(rng.integers(1, 6))
        spec["podgroups"].append({"name": f"job{j}", "min_member": int(rng.integers(1, n + 1)),
                                  "queue": str(rng.choice(["qa", "qb"])), "phase": "Pending"})
        for t in range(n):
            res = {"cpu": str(rng.choice(["500m", "1", "2"])),
                   "memory": f"{int(rng.choice([512, 1024, 2048]))}Mi"}
            if seed == 2 and t % 2:
                res["accelerator"] = "1"
            spec["pods"].append({"name": f"job{j}-{t}", "group": f"job{j}", "resources": res})
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("solve_mode", ["exact", "batch"])
@pytest.mark.parametrize("seed", range(3))
def test_gpu_scheduler_binds_equal_cpu(solve_mode, seed):
    """The cuda backend (the kernels) binds exactly what the cpu backend
    (their plain versions) binds, with the same PodGroup phases."""
    _cuda()
    states = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_spec(seed))
        conf = full_conf(backend)
        conf.solve_mode = solve_mode
        sched = Scheduler(store, conf=conf)
        K.reset_launches()
        sched.run_once()
        if backend == "cuda":
            assert K.LAUNCHES["allocate_solve_batch" if solve_mode == "batch"
                              else "allocate_solve"] == 1
        states.append((
            {p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase for g in store.list("PodGroup")},
        ))
    assert states[0] == states[1]
    assert any(states[0][0].values())
