"""Process-group start-up, local multi-process launch and cross-rank
consistency checks (port of svae_tpu/parallel/multihost.py).

``initialize`` wraps ``torch.distributed.init_process_group``.
``param_fingerprint`` gives a cheap hash of a parameter tree; asserting it
is identical across ranks catches replicated-state divergence early.

Failure model: a rank that dies or never starts surfaces as a start-up
barrier timeout in every rank that did, and ``initialize`` re-raises it
with what to do. Recovery is checkpoint-restart on the SAME fixed mesh
(train/checkpoint.py and experiment.run's generator resume); elastic resize
is a non-goal: the natural-gradient scaling (N / global_batch) and the mesh
axes are fixed when the step is built, so a changed rank count means a
fresh ``initialize`` and a resume from the latest checkpoint. There is no
fallback: a group that cannot form, a rank that fails or a collective that
times out makes the run fail.
"""

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from svae_tpu_torch.utils.pytree import tree_leaves

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout_secs=300, device="cuda"):
    """Join (or form) the default process group. Returns ``False`` when
    one is already initialized, ``True`` after forming it.

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); ``world_size=1`` with no
    ``init_method`` forms a one-rank group on an in-process store. Otherwise
    pass ``init_method`` (``tcp://host:port`` or ``file://path``),
    ``world_size`` and ``rank``. ``backend=None`` is ``"nccl"`` unless
    ``device`` is the CPU, then ``"gloo"``; with NCCL under torchrun the
    rank's card is ``cuda:$LOCAL_RANK``.

    ``timeout_secs`` bounds the start-up barrier and every collective: if
    not every rank joins in time (a host is down, preempted or
    mis-addressed), the timeout is raised as a ``RuntimeError`` that says
    so, not an indefinite hang."""
    if dist.is_initialized():
        return False
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    kw = dict(timeout=datetime.timedelta(seconds=timeout_secs))
    if init_method is None and world_size == 1:
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    else:
        if init_method is None and not all(k in os.environ
                                           for k in _TORCHRUN_ENV):
            raise ValueError(
                "initialize() needs torchrun's environment "
                f"({', '.join(_TORCHRUN_ENV)}) or an init_method with "
                "world_size and rank")
        kw.update(init_method=init_method or "env://",
                  world_size=-1 if world_size is None else world_size,
                  rank=-1 if rank is None else rank)
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    try:
        dist.init_process_group(backend, **kw)
    except RuntimeError as e:
        msg = str(e).lower()
        if "timeout" not in msg and "timed out" not in msg:
            raise
        n = world_size or os.environ.get("WORLD_SIZE", "the expected")
        me = rank if rank is not None else os.environ.get("RANK", "?")
        raise RuntimeError(
            f"process group start-up timed out after {timeout_secs}s on "
            f"rank {me}: not all {n} processes joined ({e}); a host is "
            "down, preempted, or mis-addressed. This mesh is fixed-size "
            "(no elastic resize): restart the full job and resume from "
            "the latest checkpoint.") from e
    return True


def spawn_local(fn, nprocs, args=(), timeout_secs=300):
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes on this host
    (the ``spawn`` start method) and wait for all of them, at most
    ``timeout_secs``. Raises if any process raises or exits non-zero, and
    terminates every process still running when the time is up or one has
    failed. ``fn`` forms its own group (``initialize`` with an
    ``init_method``, ``world_size=nprocs`` and ``rank``)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_secs
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} ranks of {getattr(fn, '__name__', fn)} still "
                    f"running after {timeout_secs}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def _param_leaves(params):
    """Leaves of a parameter tree in order, a net (``nn.Module``) as its
    ``parameters()``."""
    out = []
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
        else:
            out.append(leaf)
    return out


def param_fingerprint(params):
    """Deterministic fingerprint (2,) of a parameter tree, in float32 on
    its device: ``sum(v * cos(0.1 i))`` and ``sum(|v|)`` over the leaves
    flattened in order. Compare across ranks with
    :func:`assert_replicated_consistent`."""
    leaves = _param_leaves(params)
    dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
               None)
    v = torch.cat([torch.as_tensor(x, device=dev).detach().reshape(-1)
                   .to(torch.float32) for x in leaves])
    # two decorrelated reductions make collisions across divergent
    # replicas vanishingly unlikely
    i = torch.arange(v.shape[0], dtype=torch.float32, device=v.device)
    return torch.stack([(v * torch.cos(0.1 * i)).sum(), v.abs().sum()])


def assert_replicated_consistent(params, mesh, axis="data", atol=0.0):
    """Check that every rank on ``mesh``'s ``axis`` (the ranks that share
    this rank's other index) holds the same parameters: all-gathers the
    fingerprint over that axis's group and compares. Raises
    ``AssertionError`` on every rank of the group if they differ by more
    than ``atol``; returns the largest difference."""
    group = mesh.groups[axis]
    if group is None:
        raise ValueError(f"rank {dist.get_rank()} holds no shard of the "
                         f"mesh {mesh.shape}")
    fp = param_fingerprint(params)
    fps = [torch.empty_like(fp) for _ in range(dist.get_world_size(group))]
    dist.all_gather(fps, fp, group=group)
    fps = torch.stack(fps)
    diff = float((fps - fps[0]).abs().max())
    if diff > atol:
        raise AssertionError(
            f"replicated params diverged across '{axis}' shards: "
            f"max fingerprint diff {diff}")
    return diff
