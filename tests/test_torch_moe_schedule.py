"""The fused MoE router's schedule for the positions, mirrored on the CPU.

``csrc/moe_route.cu`` ranks each (token, slot) inside its warp with
``__match_any_sync`` on top of the warp's running histogram, scans the
histograms over the block's warps, sums the counts of the blocks before it
in its cluster, and adds the counts of every cluster before its own, read
32 clusters a step from the words they publish.  No CUDA kernel runs here,
so ``kernels/moe_route.moe_positions_tiled`` replays that schedule in
plain torch, and these tests hold it against ``ref.moe_positions_ref``
(the reference's one-hot cumsum) bit for bit: on tiles that do not divide
T, on tokens of more than 32 slots, on the repeated-expert rows, on
clusters of one to eight blocks and on more than 32 clusters.  Blocks start
on token boundaries (``moe_tiling``), so no tile boundary falls inside a
token's slots.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_route as tmoe
from repro_torch.kernels import ref as tref


def _routes(t: int, e: int, k: int, seed: int, skew: float = 0.0) -> torch.Tensor:
    """Routes of the plain router on numpy-seeded logits; ``skew`` pulls
    tokens to the first experts."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[:, :3] += skew
    bias = rng.standard_normal(e).astype(np.float32)
    return tref.moe_route_ref(torch.from_numpy(logits), torch.from_numpy(bias), k)[0]


def _check(idx: torch.Tensor, e: int, **kw) -> None:
    pos, counts = tmoe.moe_positions_tiled(idx, e, **kw)
    assert pos.dtype == torch.int32 and counts.dtype == torch.int32
    assert torch.equal(pos, tref.moe_positions_ref(idx, e))
    assert torch.equal(counts, torch.bincount(idx.reshape(-1).long(), minlength=e).int())


# (T, E, k, tile, warp): tiles that do not divide T, one token a warp and
# several, tokens of more than 32 slots (two and three chunks of a warp).
TILINGS = [
    (77, 160, 6, 16, 1),
    (77, 160, 6, 48, 3),
    (1000, 64, 8, 64, 4),
    (1, 160, 6, 16, 1),
    (33, 33, 33, 16, 1),
    (50, 80, 70, 32, 2),
    (300, 256, 8, 18, 1),
]


@pytest.mark.parametrize("t,e,k,tile,warp", TILINGS)
@pytest.mark.parametrize("cluster", [1, 3, 8])
def test_matches_the_reference(t, e, k, tile, warp, cluster):
    _check(_routes(t, e, k, seed=t + e + k, skew=2.0), e, tile=tile, warp=warp,
           cluster=cluster)


@pytest.mark.parametrize("t,e,k,tile,warp", TILINGS)
def test_random_ids(t, e, k, tile, warp):
    # Any ids, repeats inside a token included, not only routes.
    idx = torch.from_numpy(np.random.default_rng(t * k).integers(0, e, (t, k)).astype(np.int32))
    _check(idx, e, tile=tile, warp=warp, cluster=3)


@pytest.mark.parametrize("e,k", [(8, 3), (160, 6), (64, 40)])
def test_repeated_expert_rows(e, k):
    # Every score but k - 1 below -1e30: the last sweep takes an expert again.
    rng = np.random.default_rng(e)
    logits = torch.from_numpy(rng.standard_normal((200, e)).astype(np.float32))
    bias = torch.full((e,), 2e30)
    bias[torch.from_numpy(rng.choice(e, k - 1, replace=False))] = 0.0
    idx = tref.moe_route_ref(logits, bias, k)[0]
    assert bool((idx[:, -1:] == idx[:, :-1]).any(1).all())
    _check(idx, e, tile=16, warp=1, cluster=8)
    _check(idx, e, tile=32, warp=4, cluster=2)


@pytest.mark.parametrize("clusters", [1, 31, 32, 40])
def test_look_back_past_one_window(clusters):
    # A cluster sums the counts of the clusters before it, 32 a step: 40
    # clusters take a second step (one block a cluster, 8 tokens a block).
    idx = _routes(8 * clusters, 160, 6, seed=clusters)
    _check(idx, 160, tile=8, warp=1, cluster=1)


@pytest.mark.parametrize("t,max_clusters", [(1, 30), (4, 30), (77, 30), (2048, 30),
                                            (2048, 16), (16384, 15), (2113, 15), (10**6, 15)])
def test_tiling_covers_every_token_once(t, max_clusters):
    per_warp, warps, blocks, cluster = tmoe.moe_tiling(t, max_clusters)
    tile = warps * per_warp
    assert blocks % cluster == 0 and blocks <= tmoe.MOE_CLUSTER * max_clusters
    assert tmoe.MOE_MIN_WARPS <= warps <= tmoe.MOE_MAX_WARPS
    assert (blocks - cluster) * tile < t <= blocks * tile
    # One token a warp while the blocks hold a warp a token.
    fits = t <= tmoe.MOE_MAX_WARPS * tmoe.MOE_CLUSTER * max_clusters
    assert (per_warp == 1) == fits


@pytest.mark.parametrize("t", [2048, 4096])
def test_the_kernels_tiling(t):
    # The card's own schedule at the main path's T and a longer chunk, with
    # the 15 clusters of eight one-SM CTAs one H100 holds.
    per_warp, warps, _, cluster = tmoe.moe_tiling(t, 15)
    _check(_routes(t, 160, 6, seed=t, skew=1.0), 160, tile=warps * per_warp, warp=per_warp,
           cluster=cluster)


def test_refuses_a_tile_that_splits_a_warp():
    with pytest.raises(ValueError, match="multiple"):
        tmoe.moe_positions_tiled(torch.zeros((4, 2), dtype=torch.int32), 4, tile=6, warp=4,
                                 cluster=1)
