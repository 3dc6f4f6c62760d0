"""Distributed training over ``torch.distributed`` (port of
svae_tpu/parallel/).

A rank mesh (``mesh.make_mesh``) and a train step with its collectives
placed by hand where the SVI math needs them:

  * ``data`` axis: minibatch sharding; a sum of (a) the expected
    sufficient statistics feeding the conjugate natural gradient and (b)
    the recognition / decoder gradients;
  * ``mc`` axis: Monte-Carlo particles sharded across ranks; their terms
    averaged.

Both reductions are one ``all_reduce`` a step (``dp.make_dp_train_step``),
on NCCL between cards and gloo on the CPU. ``multihost.initialize`` forms
the process group; ``time_shard.lds_smoother_timeshard`` splits one
chain's time axis over a group.
"""

from svae_tpu_torch.parallel.mesh import make_mesh, local_batch_size
from svae_tpu_torch.parallel.dp import make_dp_train_step

__all__ = ["make_mesh", "local_batch_size", "make_dp_train_step"]
