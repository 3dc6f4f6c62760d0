"""Input pipeline: shuffled epochs, length-bucketed ragged batches and
device prefetch (port of svae_tpu/data/loader.py).

* **Length bucketing.** A ragged corpus is padded batch by batch: each
  (shuffled) epoch is sorted by length, neighbours are batched, and every
  batch is padded up to a multiple of ``pad_multiple``, so the padding is
  small and an epoch has few distinct shapes. Batches carry ``lengths`` for
  the exact ragged-batch semantics of ``models.lds.run_inference(lengths=)``.
* **Reproducibility.** Shuffling derives from one integer seed folded with
  the epoch index: the order is a function of ``(seed, epoch)``, the same
  batches and lengths as the JAX package's loader gives (tested).
* **Copies queued ahead.** ``prefetch_to_device`` keeps the next batches'
  host-to-card copies queued, from pinned host memory with ``non_blocking``
  copies. They are asynchronous to the host, which goes on issuing the
  current step, but they run on the current stream, in order behind the
  kernels already issued: they do not overlap device compute.

Host-side work is NumPy (index permutations and padding).
"""

import collections
import itertools

import numpy as np
import torch

from svae_tpu_torch.data.masking import pad_batch
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map


def _rng(seed, epoch):
    return np.random.RandomState((int(seed) * 1_000_003 + int(epoch))
                                 % (2 ** 31 - 1))


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def epoch_batches(data, batch_size, seed=0, epoch=0, drop_remainder=True):
    """Yield shuffled minibatches of a dense array (or nested tuple of
    arrays or tensors with a shared leading axis) as NumPy arrays. The
    order is a function of ``(seed, epoch)``."""
    data_np = tree_map(_host, data)     # one device-to-host copy per epoch
    n = int(tree_leaves(data_np)[0].shape[0])
    perm = _rng(seed, epoch).permutation(n)
    stop = (n - batch_size + 1) if drop_remainder else n
    for lo in range(0, max(stop, 0), batch_size):
        idx = perm[lo:lo + batch_size]
        yield tree_map(lambda a: a[idx], data_np)


def _round_up(t, m):
    return -(-int(t) // int(m)) * int(m)


def ragged_epoch_batches(sequences, batch_size, seed=0, epoch=0,
                         pad_multiple=8, drop_remainder=False,
                         dtype=None, group_by_shape=False):
    """Length-bucketed epoch over a ragged corpus.

    ``sequences`` is a list of (T_i, d) arrays. Each epoch: shuffle the
    corpus, stable-sort by length, batch consecutive sequences, pad each
    batch to ``round_up(max_len_in_batch, pad_multiple)`` and shuffle the
    batch order. Yields NumPy ``(batch (B, Tpad, d), lengths (B,))`` for
    ``run_inference(lengths=)``. With ``drop_remainder=False`` a corpus that
    ``batch_size`` does not divide ends in one smaller batch.

    ``group_by_shape=True`` emits the batches of one padded T
    consecutively (group order shuffled, the smaller tail batch last), so
    ``train.loop.run_loader(steps_per_dispatch=k)`` groups fill; the
    multiset of batches is the same as without it."""
    n = len(sequences)
    rng = _rng(seed, epoch)
    perm = rng.permutation(n)
    order = sorted(perm, key=lambda i: int(sequences[i].shape[0]))
    spans = []
    stop = (n - batch_size + 1) if drop_remainder else n
    for lo in range(0, max(stop, 0), batch_size):
        spans.append(order[lo:lo + batch_size])
    rng.shuffle(spans)
    if group_by_shape:
        groups = collections.OrderedDict()  # padded T -> spans, epoch order
        tail = None
        for idx in spans:
            if len(idx) < batch_size:
                tail = idx
                continue
            Tp = _round_up(max(int(sequences[i].shape[0]) for i in idx),
                           pad_multiple)
            groups.setdefault(Tp, []).append(idx)
        keys = list(groups)
        rng.shuffle(keys)
        spans = [s for Tp in keys for s in groups[Tp]]
        if tail is not None:
            spans.append(tail)
    for idx in spans:
        group = [sequences[i] for i in idx]
        Tmax = max(int(s.shape[0]) for s in group)
        yield pad_batch(group, T=_round_up(Tmax, pad_multiple), dtype=dtype)


def prefetch_to_device(iterator, size=2, device="cuda"):
    """Wrap a host batch iterator so that ``size`` batches are always on
    their way to ``device``: each NumPy leaf is copied into pinned host
    memory and sent with a ``non_blocking`` copy on the current stream.
    The host does not wait for the copy; the card runs it in stream order,
    after the kernels issued before it. On a CPU ``device`` the leaves
    become tensors without pinning."""
    device = torch.device(device)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    it = iter(iterator)
    queue = collections.deque(tree_map(put, b)
                              for b in itertools.islice(it, size))
    while queue:
        out = queue.popleft()
        queue.extend(tree_map(put, b) for b in itertools.islice(it, 1))
        yield out


def make_loader(data_or_sequences, batch_size, seed=0, *, ragged=None,
                pad_multiple=8, drop_remainder=None, prefetch=2,
                device="cuda", group_by_shape=False):
    """Epoch-loader factory: ``loader(epoch) -> iterator of batches``.

    A dense corpus (array, tensor or nested tuple of them) yields shuffled
    minibatches; a ragged corpus (a list of (T_i, d) arrays; detected, or
    forced with ``ragged=``) yields length-bucketed ``(batch, lengths)``
    pairs. Batches are tensors on ``device`` (default the card) with
    ``prefetch`` of them in flight; ``prefetch=0`` yields the NumPy batches
    as they are. Ragged corpora default to ``drop_remainder=False`` (every
    sequence seen each epoch; the objective scales by the actual batch
    size, so a smaller tail batch is exact); ``group_by_shape`` is
    :func:`ragged_epoch_batches`'."""
    if ragged is None:
        ragged = isinstance(data_or_sequences, (list, tuple))
    if drop_remainder is None:
        drop_remainder = not ragged

    def loader(epoch):
        if ragged:
            it = ragged_epoch_batches(
                data_or_sequences, batch_size, seed, epoch,
                pad_multiple=pad_multiple, drop_remainder=drop_remainder,
                group_by_shape=group_by_shape)
        else:
            it = epoch_batches(data_or_sequences, batch_size, seed, epoch,
                               drop_remainder=drop_remainder)
        if prefetch:
            return prefetch_to_device(it, size=prefetch, device=device)
        return it

    return loader
