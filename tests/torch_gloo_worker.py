"""One rank of the gloo rehearsals in ``tests/test_torch_parallel.py``
(the sharded cycle, the victim solve on node blocks),
``tests/test_torch_contention_mesh.py`` (the contention solves on node
blocks) and ``tests/test_torch_multihost.py`` (the multi-controller
cycle).

A module of its own, importing neither JAX nor the JAX package, so that
each spawned rank starts with torch and the port alone."""

import os

import numpy as np
import torch


def run_rank(rank, world, store_path, out_dir, n_blocks, sim_args):
    """Join a gloo group of ``world`` ranks through a FileStore, run the
    sharded cycle on ``build_sim_args(**sim_args)`` with ``n_blocks``
    blocks over the group, and save this rank's outputs (node planes
    gathered) to ``out_dir/rank{rank}.npz``."""
    import torch.distributed as dist

    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    _join(rank, world, store_path)
    try:
        mesh = S.make_mesh(n_blocks)
        assert isinstance(mesh, S.GroupMesh) and mesh.n_local == n_blocks // world
        fn, dargs = S.make_sharded_cycle(mesh, build_sim_args(**sim_args), m_chunk=32,
                                         p_chunk=8)
        out = S.fetch_outputs(fn(dargs), mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), *out)
    finally:
        dist.destroy_process_group()


def _join(rank, world, store_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)


def run_rank_victim(rank, world, store_path, out_dir, n_blocks, sim, preemptors, kw):
    """Join a gloo group, run the chain ``preemptors`` of (t_req, t_cls, jt,
    qt) through ``make_sharded_victim_step`` on ``n_blocks`` blocks over the
    group with ``build_victim_sim(**sim)`` and the flags ``kw``, and save
    each decision and the final state (node planes gathered) to
    ``out_dir/victim{rank}.npz``."""
    import torch.distributed as dist

    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler.simargs import build_victim_sim
    from volcano_tpu_torch.scheduler.victim_kernels import VictimConsts, VictimState

    _join(rank, world, store_path)
    try:
        mesh = S.make_mesh(n_blocks)
        assert isinstance(mesh, S.GroupMesh) and mesh.n_local == n_blocks // world
        c_np, s_np = build_victim_sim(**sim)
        fn, dc, ds = S.make_sharded_victim_step(mesh, VictimConsts(**c_np),
                                                VictimState(**s_np), **kw)
        out = {}
        for i, (t_req, t_cls, jt, qt) in enumerate(preemptors):
            new, assigned, nstar, vmask, clean = fn(dc, ds, t_req, t_cls, jt, qt)
            out[f"decision{i}"] = np.array([assigned, nstar, clean])
            out[f"vmask{i}"] = vmask
            if assigned:
                ds = new
        for name in VictimState._fields:
            x = getattr(ds, name)
            if isinstance(x, tuple):
                x = mesh.gather_rows(torch.cat(x))
            out[name] = x.numpy()
        np.savez(os.path.join(out_dir, f"victim{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_rank_multihost(rank, world, store_path, out_dir, n_hosts, n_blocks, sim_args):
    """Join a gloo group as host ``rank // (world / n_hosts)``, run the
    multi-controller cycle on ``build_sim_args(**sim_args)`` with
    ``n_blocks`` node blocks and the task planes split over the hosts, and
    save the outputs (node planes gathered) and this rank's owned slices to
    ``out_dir/mh{rank}.npz``."""
    import torch.distributed as dist

    from volcano_tpu_torch.parallel import multihost as MH
    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    _join(rank, world, store_path)
    try:
        mesh = MH.make_host_mesh(n_hosts, n_blocks)
        assert isinstance(mesh, MH.GroupHostMesh) and mesh.hosts == n_hosts
        args = build_sim_args(**sim_args)
        fn, dargs = MH.make_multihost_cycle(mesh, args, m_chunk=32, p_chunk=8)
        # this rank holds its host's task block only
        lo, hi = MH.host_bounds(args["task_req"].shape[0], n_hosts)[mesh.host]
        assert dargs["task_req"].shape[0] == hi - lo
        out = fn(dargs)
        full = S.fetch_outputs(out, mesh)
        owned = MH.owned_output_slices(out, mesh.host, n_hosts, mesh)
        np.savez(os.path.join(out_dir, f"mh{rank}.npz"),
                 **{f"out_{n}": x for n, x in zip(MH.OUTPUT_NAMES, full)},
                 **{f"own_{n}": x for n, x in owned.items()})
    finally:
        dist.destroy_process_group()


def contention_case(kind, seed, kw):
    """(consts, state, positional inputs) of a seeded storm case for
    ``reclaim_solve`` / ``preempt_solve`` / ``preempt_rounds`` as tensors:
    ``build_storm_sim`` and ``storm_inputs`` (``kw["big"]`` / ``n_new``
    shape the sim, the rest are the solve's flags)."""
    from volcano_tpu_torch import interop
    from volcano_tpu_torch.scheduler.simargs import build_storm_sim, storm_inputs

    sim = {k: kw[k] for k in ("big", "n_new") if k in kw}
    c, s, t = build_storm_sim(seed, **sim)
    tc, ts = interop.victim_from_arrays(c, s)
    args = [a if isinstance(a, int) else torch.from_numpy(np.asarray(a))
            for a in storm_inputs(kind, c, s, t)]
    return tc, ts, args


def run_rank_contention(rank, world, store_path, out_dir, n_blocks, cases):
    """Join a gloo group, run each (kind, seed, flags) of ``cases`` through
    the contention solve on ``n_blocks`` node blocks over the group
    (``reclaim_solve_sharded`` / ``preempt_solve_sharded`` /
    ``preempt_rounds_sharded``: on CPU tensors their plain versions, the
    records exchanged over the group), and save every output, node planes
    gathered, to ``out_dir/contention{rank}.npz``."""
    import torch.distributed as dist

    from volcano_tpu_torch.parallel import sharded as S
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    _join(rank, world, store_path)
    try:
        mesh = S.make_mesh(n_blocks)
        assert isinstance(mesh, S.GroupMesh) and mesh.n_local == n_blocks // world
        out = {}
        for i, (kind, seed, kw) in enumerate(cases):
            tc, ts, args = contention_case(kind, seed, kw)
            flags = {k: v for k, v in kw.items() if k not in ("big", "n_new")}
            fn = getattr(VK, {"reclaim": "reclaim_solve", "preempt": "preempt_solve",
                              "rounds": "preempt_rounds"}[kind] + "_sharded")
            res = fn(S._place_victim(mesh, tc), S._place_victim(mesh, ts), *args, mesh, **flags)
            for name, x in flat_outputs(res).items():
                if isinstance(x, tuple):
                    x = mesh.gather_rows(torch.cat(x))
                out[f"{i}:{name}"] = x.numpy()
        np.savez(os.path.join(out_dir, f"contention{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def flat_outputs(res):
    """A solve's outputs by dotted name (the records' fields under rec.)."""
    out = {}
    for f in res._fields:
        x = getattr(res, f)
        if hasattr(x, "_fields"):
            out.update({f"{f}.{g}": getattr(x, g) for g in x._fields})
        else:
            out[f] = x
    return out
