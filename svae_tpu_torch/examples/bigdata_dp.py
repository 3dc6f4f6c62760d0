"""Large-batch data-parallel natural-gradient SVI (BASELINE config 5):
LDS-SVAE over a large synthetic sequence corpus, sharded over the ranks of
a process group with one all_reduce of the natural-gradient statistics and
the net gradients a step.

    python -m svae_tpu_torch.examples.bigdata_dp [--preset bigdata_dp_smoke]
        [--num_seqs 5120] [--device cpu] ...
    torchrun --nproc_per_node=2 -m svae_tpu_torch.examples.bigdata_dp \\
        --device cpu

Under torchrun every rank joins the group from torchrun's environment (one
card a rank, NCCL; gloo with ``--device cpu``). Launched on its own it
forms a one-rank group, so the step still goes through the collective.
Each data index synthesizes its own shard of the corpus (``num_seqs``
sequences, standing in for a sharded loader over a large corpus); ranks
that share a data index hold the same shard and draw their own particles.
The last line is ``steps= first_elbo= last_elbo= seqs/sec=``.
"""

import os
import time

import torch
import torch.distributed as dist

from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.examples._common import parse, train_kwargs
from svae_tpu_torch.examples.lds_dots import build
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.parallel import make_dp_train_step, make_mesh, multihost
from svae_tpu_torch.train.metrics import MetricsWriter


def main(argv=None):
    cfg, device = parse("bigdata_dp", argv)
    tc = cfg.train
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        formed = multihost.initialize(device=device)
        if torch.device(device).type == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
    else:
        formed = multihost.initialize(world_size=1, device=device)
    try:
        return _train(cfg, tc, device)
    finally:
        if formed:
            dist.destroy_process_group()


def _train(cfg, tc, device):
    mesh = make_mesh(data=cfg.data_parallel, mc=cfg.mc_parallel)
    rank = dist.get_rank()
    print(f"mesh: {mesh.shape} over {dist.get_world_size()} ranks "
          f"({dist.get_backend()})")
    if not mesh.on_mesh:
        print(f"rank {rank}: beyond the mesh, no shard")
        return []

    # the corpus of this data index; N counts every data index's
    data = torch.from_numpy(make_dot_data(
        seed=tc.seed + mesh.data_index, num_seqs=cfg.num_seqs, T=cfg.T,
        image_width=cfg.image_width)).to(device)
    N = cfg.num_seqs * mesh.shape["data"]
    # the same initial parameters on every rank
    pgm_prior, pgm_params, net_params = build(
        cfg, torch.Generator().manual_seed(tc.seed), device)

    # tc.batch_size is the GLOBAL batch; each data index feeds its slice,
    # so the N / global_batch scaling counts each sequence once
    Bg = tc.batch_size
    opt_init, train_step = make_dp_train_step(
        lds.run_inference, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, mesh, Bg, **train_kwargs(tc))
    B_local = Bg // mesh.shape["data"]
    opt_state = opt_init(pgm_params, net_params)
    generator = torch.Generator(device=device).manual_seed(tc.seed)

    # one writer: ranks share the host's file system
    writer = MetricsWriter(tc.metrics_path if rank == 0 else None)
    num_batches = data.shape[0] // B_local
    hist = []
    p, n, s = pgm_params, net_params, opt_state
    step = 0
    t0 = time.perf_counter()
    # the metrics fence the card: take them every metrics_every steps
    every = max(1, tc.metrics_every)
    for _ in range(tc.num_epochs):
        for b in range(num_batches):
            batch = data[b * B_local:(b + 1) * B_local]
            p, n, s, e, terms = train_step(p, n, s, batch, generator)
            hist.append(e)  # device scalar: no host sync
            step += 1
            if step % every == 0:
                writer.write(step - 1, elbo=float(e),
                             **{k: float(v) for k, v in terms.items()})
    hist = torch.stack(hist).tolist() if hist else []
    dt = time.perf_counter() - t0
    multihost.assert_replicated_consistent((p, n), mesh)
    writer.close()
    if hist:
        print(f"steps={len(hist)} first_elbo={hist[0]:.4f} "
              f"last_elbo={hist[-1]:.4f} "
              f"seqs/sec={len(hist) * Bg / dt:.1f}")
    return hist


if __name__ == "__main__":
    main()
