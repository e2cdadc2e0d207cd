"""One rank of the gloo rehearsal in ``tests/test_torch_parallel.py``.

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

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = S.make_mesh(n_blocks)
        assert isinstance(mesh, S.GroupMesh) and mesh.n_local == n_blocks // world
        fn, dargs = S.make_sharded_cycle(mesh, build_sim_args(**sim_args), m_chunk=32,
                                         p_chunk=8)
        out = S.fetch_outputs(fn(dargs), mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), *out)
    finally:
        dist.destroy_process_group()
