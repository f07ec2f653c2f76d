"""The port's mesh paths over gloo ranks on the CPU, for
tests/test_torch_collective_planner.py (a helper script, not a test file).

    python tests/torch_mesh_ranks.py WORLD OUT_DIR

starts WORLD ranks with ``spawn``; they meet through a ``FileStore`` in
OUT_DIR and write what they computed there, one ``.npz`` and one ``.json``
a rank and case; the test compares it with the JAX package.  World 2 runs
``sharded_softmax_xent`` on a (1, 2) mesh; world 4 runs it on (2, 2) and
(1, 4), ``compressed_psum`` on both, and two steps of the mesh train step
on (2, 2) under both planner strategies and the plain loss.  Nothing here
imports JAX.
"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the loss inputs: glm4's smoke width, a real vocab that is not a multiple
# of any shard width (500 of a padded 512)
B, S, D, VOCAB = 4, 8, 64, 500
STEP_BATCH, STEP_SEQ, STEPS = 4, 16, 2


def xent_inputs(Vp):
    """h (B, S, D), unembed (D, Vp), labels (B, S) from numpy, seed 0."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, Vp)) * 0.2).astype(np.float32)
    y = rng.integers(0, VOCAB, size=(B, S)).astype(np.int64)
    return h, w, y


def _save(out_dir, name, rank, arrays, meta):
    np.savez(f"{out_dir}/{name}.r{rank}.npz", **arrays)
    with open(f"{out_dir}/{name}.r{rank}.json", "w") as f:
        json.dump(meta, f)


def run_xent(mesh, rank, out_dir, tag):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.parallel.collective_planner import (record_collectives,
                                                         sharded_softmax_xent)
    from repro_torch.parallel.sharding import (batch_spec, local_shard,
                                               spec_for)
    Vp = get_smoke_config("glm4-9b").with_(vocab_size=VOCAB).padded_vocab
    h, w, y = (torch.from_numpy(a) for a in xent_inputs(Vp))
    rows = batch_spec(mesh, B)
    cols = spec_for(("embed", "vocab"), (D, Vp), mesh)
    for strategy in ("dist", "gather"):
        hl = local_shard(h, rows, mesh).clone().requires_grad_(True)
        wl = local_shard(w, cols, mesh).clone().requires_grad_(True)
        yl = local_shard(y, rows, mesh)
        with record_collectives() as fwd:
            loss = sharded_softmax_xent(hl, wl, yl, mesh, real_vocab=VOCAB,
                                        strategy=strategy)
        with record_collectives() as bwd:
            loss.backward()
        _save(out_dir, f"xent_{tag}_{strategy}", rank,
              {"loss": loss.detach().numpy(), "gh": hl.grad.numpy(),
               "gw": wl.grad.numpy()},
              {"coord": list(mesh.get_coordinate()), "fwd": fwd, "bwd": bwd,
               "Vp": Vp})


def run_compressed(mesh, rank, out_dir, tag):
    from repro_torch.parallel.compression import compressed_psum
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    mine = torch.from_numpy(np.random.default_rng(10 + rank).normal(
        size=(16, 8)).astype(np.float32))
    out = {}
    for axis in mesh.mesh_dim_names:
        out[f"same_{axis}"] = compressed_psum(g, mesh, axis).numpy()
        out[f"mine_{axis}"] = compressed_psum(mine, mesh, axis).numpy()
    _save(out_dir, f"compressed_{tag}", rank,
          dict(out, g=g.numpy(), x=mine.numpy()),
          {"coord": list(mesh.get_coordinate())})


def run_train_steps(mesh, rank, out_dir):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (TrainState, make_train_step,
                                              shard_params)
    opt_cfg = OptConfig(warmup_steps=1, total_steps=STEPS)
    for name, strategy, planner in (("dist", "dist", True),
                                    ("gather", "gather", True),
                                    ("plain", "auto", False)):
        cfg = get_smoke_config("glm4-9b").with_(dtype="float32",
                                                softmax_strategy=strategy)
        model = Model(cfg)
        params = shard_params(model, model.init(0, device="cpu"), mesh,
                              planner)
        state = TrainState(params, init_opt_state(params))
        step = make_train_step(model, opt_cfg, mesh,
                               use_planner_loss=planner)
        data = SyntheticLM(cfg.vocab_size, STEP_SEQ, STEP_BATCH, seed=0)
        arrays, losses, records = {}, [], []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data.batch(i).items()}
            with record_collectives() as rec:
                state, metrics = step(state, batch)
            records.append(rec)
            losses.append(float(metrics["loss"]))
            for n, t in flatten_with_names(state.params):
                arrays[f"step{i}{n}"] = t.detach().numpy().copy()
        _save(out_dir, f"train_{name}", rank, arrays,
              {"coord": list(mesh.get_coordinate()), "losses": losses,
               "records": records})


def _rank(rank, world, out_dir):
    from repro_torch.launch.mesh import make_auto_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(out_dir + "/store", world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        if world == 2:
            run_xent(make_auto_mesh((1, 2), ("data", "model"), "cpu"), rank,
                     out_dir, "1x2")
        else:
            m22 = make_auto_mesh((2, 2), ("data", "model"), "cpu")
            m14 = make_auto_mesh((1, 4), ("data", "model"), "cpu")
            run_xent(m22, rank, out_dir, "2x2")
            run_xent(m14, rank, out_dir, "1x4")
            run_compressed(m22, rank, out_dir, "2x2")
            run_compressed(m14, rank, out_dir, "1x4")
            run_train_steps(m22, rank, out_dir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, out = int(sys.argv[1]), sys.argv[2]
    mp.start_processes(_rank, args=(world, out), nprocs=world,
                       start_method="spawn")
