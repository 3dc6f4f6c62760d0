"""What the stationary HMM forward's kernel reads and writes
(svae_tpu_torch/ops/hmm_fb.py: hmm_fb_stat_fwd, csrc/hmm_fb.cu:
hmm_fb_stat_fwd_kernel), in float64 on the CPU, with no JAX.

The kernel runs each chain on segment_lanes(K) adjacent lanes of a warp,
alpha chains first, lane j of a segment owning state j; lanes past the
last chain and K = 3's idle lane shadow a real lane and store nothing. A
lane holds its K entries of LT (column j for alpha, row j for beta) and
streams only observations through a ring of R steps: lo_t(j) for t = s
ascending (alpha) or t = T-2-s descending (beta), the source clamped at the
chain's last step; a beta lane takes lo_t(k) from lane k of its segment by
a shuffle. A step shuffles the K carried values within the segment and
takes one max-shifted logsumexp of (LT + lo) + carry. ``_lane_chain`` replays that indexing lane by lane and
must give ``hmm_fb_stat_fwd_plain`` (torch.logsumexp over the whole
matrix) at rtol 1e-8 / atol 1e-10, every output written exactly once. The
kernel itself is held to the plain version, and bit for bit to
``hmm_fb_fwd`` on the packed LT + lo, on a card by
tests/test_torch_kernels.py."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import hmm_fb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
LANES = 32  # a warp, the kernel's block


def _constant(name):
    """A compile-time constant of csrc/hmm_fb.cu, as built."""
    path = os.path.join(ROOT, "svae_tpu_torch", "csrc", "hmm_fb.cu")
    with open(path) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    if m is None:
        raise LookupError(f"{path} defines no constexpr int {name}")
    return int(m.group(1))


RING = _constant("kHmmStatRing")
# the state counts replayed: those built before K=5..32 were (1, 2, 3, 4,
# 8), and 5 (three idle lanes of a segment of 8), 16 and 32 (a whole warp a
# chain); replaying every built K lane by lane would multiply the file's
# time by four
STATES = (1, 2, 3, 4, 5, 8, 16, 32)
assert set(STATES) <= set(hmm_fb.KERNEL_STATES)
# (K, T, B): each of STATES, one step (T=2) and a short chain, at B=5
# sequences (10 chains, no multiple of the chains a warp holds at any K
# below 32) and B=17 (34 chains: several warps, the last one partial at
# K=3, 5, 8)
CASES = [(K, T, B) for K in STATES for T in (2, 7) for B in (5, 17)]


def _problem(K, T, seed, case="stationary", B=5):
    """``hmm_fb_stat_fwd``'s float64 arguments (a0, LT, lo) on
    chip_smoke.hmm_problem's problem at B sequences."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    li, lt, lo, _ = chip_smoke.hmm_problem(dict(B=B, T=T, K=K), seed,
                                           device="cpu", case=case)
    return chip_smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_stat_fwd"]


def _segment_lanes(k):
    w = 1
    while w < k:
        w *= 2
    return w


def _lse(v):
    """The kernel's logsumexp of K terms (a list of lane arrays): the max,
    then the sum of the shifted exps in index order."""
    mx = v[0]
    for x in v[1:]:
        mx = np.maximum(mx, x)
    s = np.zeros_like(mx)
    for x in v:
        s = s + np.exp(x - mx)
    return np.log(s) + mx


def _lane_chain(a0, LT, lo, ring=RING):
    """hmm_fb_stat_fwd_kernel's lanes on the C entry's arguments, every
    lane of every block that does not leave whole, a step at a time.
    Returns alpha, beta (T-1, K, B) and how often each element was
    written."""
    a0, LT, lo = (x.numpy() for x in (a0, LT, lo))
    K, B = a0.shape
    T1 = lo.shape[0]
    W, KB = _segment_lanes(K), K * B
    blocks = -(-2 * B * W // LANES)
    g = np.arange(blocks * LANES)
    g = g[(g - g % LANES) // W < 2 * B]      # a warp past the chains leaves
    live = (g // W < 2 * B) & (g % W < K)
    chain = np.minimum(g // W, 2 * B - 1)
    j = np.minimum(g % W, K - 1)
    fwd = chain < B
    b = np.where(fwd, chain, chain - B)
    seg = g - g % W                          # lane k of the segment: seg + k
    lt = [LT.reshape(-1)[np.where(fwd, k * K + j, j * K + k)]
          for k in range(K)]
    # the observation a lane rings a step, lo_t(j)
    step = np.where(fwd, KB, -KB)
    src = np.where(fwd, 0, (T1 - 1) * KB) + j * B + b
    last = src + (T1 - 1) * step
    flat = lo.reshape(-1)
    slots = [None] * ring

    def load(u):
        nonlocal src
        slots[u] = flat[src]
        src = np.where(src == last, src, src + step)

    for u in range(ring):
        load(u)
    c = np.where(fwd, a0.reshape(-1)[j * B + b], 0.0)
    out = np.where(fwd, j * B + b, (T1 - 1) * KB + j * B + b)
    ostep = np.where(fwd, KB, -KB)
    alpha, beta = np.full(T1 * KB, np.nan), np.full(T1 * KB, np.nan)
    writes = np.zeros((2, T1 * KB), dtype=int)
    for s0 in range(0, T1, ring):
        for u in range(ring):
            if s0 + u >= T1:
                break
            # lo_t(k) from lane k of the segment; an alpha lane keeps its own
            o = slots[u]
            m = [lt[k] + np.where(fwd, o, o[seg + k]) for k in range(K)]
            c = _lse([c[seg + k] + m[k] for k in range(K)])
            for msg, w, side in ((alpha, writes[0], fwd),
                                 (beta, writes[1], ~fwd)):
                at = live & side
                msg[out[at]] = c[at]
                np.add.at(w, out[at], 1)
            out = out + ostep
            load(u)
    shape = (T1, K, B)
    return (torch.from_numpy(alpha.reshape(shape)),
            torch.from_numpy(beta.reshape(shape)), writes)


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("K,T,B", CASES)
def test_lane_chain_gives_the_plain_stationary_forward(K, T, B):
    args = _problem(K, T, seed=K + T, B=B)
    alpha, beta, writes = _lane_chain(*args)
    assert (writes == 1).all()
    _close((alpha, beta), hmm_fb.hmm_fb_stat_fwd_plain(*args))


@pytest.mark.parametrize("K", [k for k in STATES if k > 1])
def test_lane_chain_on_a_forced_switch(K):
    """chip_smoke.hmm_problem's forced case: sticky transitions, a 0 -> 1
    entry of -100 that the observations force once, -100 evidence."""
    args = _problem(K, 9, seed=K, case="forced")
    alpha, beta, writes = _lane_chain(*args)
    assert (writes == 1).all()
    _close((alpha, beta), hmm_fb.hmm_fb_stat_fwd_plain(*args))


@pytest.mark.parametrize("ring", [1, 3, 8])
def test_lane_chain_does_not_depend_on_the_ring_depth(ring):
    """The clamped source and the slots give every step its own
    observations at any depth, shorter or longer than the chain (T=7)."""
    args = _problem(3, 7, seed=11)
    want = _lane_chain(*args)[:2]
    got = _lane_chain(*args, ring=ring)
    assert (got[2] == 1).all()
    for a, b in zip(got[:2], want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,T,case", [
    (K, T, case) for K in STATES
    for T, case in ((2, "stationary"), (7, "stationary"), (9, "forced"))
    if K > 1 or case == "stationary"])
def test_stationary_plain_is_the_streamed_plain_on_LT_plus_lo(K, T, case):
    """In float32, the plain stationary forward gives the plain streamed
    forward's messages on M = LT + lo packed, bit for bit: both form
    (LT + lo) before adding the carry (the kernels keep the same order);
    a forced switch needs two states."""
    a0, LT, lo = (x.float() for x in _problem(K, T, seed=K, case=case))
    T1, _, B = lo.shape
    M = (LT[None, :, :, None] + lo[:, None]).reshape(T1, K * K, B)
    got = hmm_fb.hmm_fb_stat_fwd_plain(a0, LT, lo)
    want = hmm_fb.hmm_fb_fwd_plain(a0, M.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
