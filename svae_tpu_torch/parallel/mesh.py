"""Rank meshes (port of svae_tpu/parallel/mesh.py).

A mesh lays the ranks of the initialized ``torch.distributed`` world, one
device each, on the axes ``("mc", "data")``: rank r holds shard
``mc_index = r // data``, ``data_index = r % data``, the layout of the JAX
package's ``devices[:data * mc].reshape(mc, data)``, the data axis the
fastest-varying. Each axis has a process group per rank: the ranks that
share the other index. A mesh needs an initialized process group
(``multihost.initialize``), as a JAX mesh needs devices; a 1x1 mesh still
runs its collectives through its one-rank group.
"""

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``shape`` is ``{"mc": mc, "data": data}``; ``data_index`` and
    ``mc_index`` are this rank's shard (``None`` on a rank beyond
    ``data * mc``, which holds none); ``groups[axis]`` is this rank's
    group over ``axis`` and ``group`` the whole mesh's (``None`` off the
    mesh)."""
    shape: dict
    data_index: Optional[int]
    mc_index: Optional[int]
    groups: dict
    group: Any

    @property
    def on_mesh(self):
        return self.data_index is not None


def make_mesh(data=None, mc=1):
    """Build a (data, mc) mesh over the initialized world.

    ``data=None`` uses all remaining ranks on the data axis. Every rank
    must call it, with the same arguments: every rank creates every group,
    in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(svae_tpu_torch.parallel.multihost.initialize)")
    n = dist.get_world_size()
    if data is None:
        if n % mc != 0:
            raise ValueError(f"{n} devices not divisible by mc={mc}")
        data = n // mc
    if data * mc > n:
        raise ValueError(f"mesh {data}x{mc} needs {data * mc} devices, "
                         f"have {n}")
    data_groups = [dist.new_group([m * data + j for j in range(data)])
                   for m in range(mc)]
    mc_groups = [dist.new_group([m * data + j for m in range(mc)])
                 for j in range(data)]
    whole = dist.new_group(list(range(data * mc)))
    shape = {"mc": mc, "data": data}
    rank = dist.get_rank()
    if rank >= data * mc:
        return Mesh(shape, None, None, {"data": None, "mc": None}, None)
    mc_index, data_index = divmod(rank, data)
    return Mesh(shape, data_index, mc_index,
                {"data": data_groups[mc_index], "mc": mc_groups[data_index]},
                whole)


def local_batch_size(global_batch, mesh):
    """Per-shard batch size on the data axis; validates divisibility."""
    n = mesh.shape["data"]
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel "
            f"degree {n}"
        )
    return global_batch // n
