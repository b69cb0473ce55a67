"""The flash kernels' tile schedules and input contract, on the CPU.

``kernels/flash_attn.key_tiles`` is the arithmetic of ``key_tiles`` and
``tile_masked`` in ``csrc/flash_attn.cu``: which 64-key tiles a block of 128
query rows of the bfloat16 kernel visits, and which of them need the mask;
with ``block_q=64, block_k=32`` the float32 kernel's (the same functions
with 32-key tiles).  A tile skipped or left
unmasked by mistake gives wrong numbers with no error, so the schedule is held
here against a brute-force list of the (query, key) pairs that the dense
softmax attends, over ragged S and T, windows from 1 to 2**31 - 1, and
queries past T - 1 + window, which have no key and average all of them.  A
walk of the schedule in float64 (masks applied only on the tiles it marks) is
held against the dense softmax within 1e-12.  The bfloat16 backward's
schedules (``bwd_key_tiles``, ``bwd_query_tiles``, ``bwd_pair`` in
``csrc/flash_attn_bwd.cu``) are held against the same brute force: each dq
block visits exactly the key tiles its rows attend, each dk/dv block exactly
the query tiles that attend its keys and, apart, the tiles of rows with no
key, and a warpgroup leaves unmasked or skips only pairs that all attend or
none does.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as tflash

BQ, BK = tflash.BLOCK_Q, tflash.BLOCK_K
F32 = dict(block_q=tflash.F32_BLOCK_Q, block_k=tflash.F32_BLOCK_K)
# (200, 163) with window 37 puts block 1's last row at exactly T - 1 + window.
SIZES = [(1, 1), (1, 300), (77, 45), (200, 200), (200, 163), (300, 100), (129, 129),
         (128, 64), (130, 127), (257, 513), (1000, 1000)]
WINDOWS = [None, 1, 37, 64, 66, 100, 4096, 2**31 - 1]


def _attended(s: int, t: int, causal: bool, window) -> np.ndarray:
    """(S, T) bool: the keys each query's dense softmax weighs; a query whose
    keys are all masked weighs all T equally."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok = k <= q
        if window is not None:
            ok &= q - k < window
    ok[~ok.any(axis=1)] = True
    return ok


def _check_blocks(s: int, t: int, causal: bool, window, block_q=BQ, block_k=BK) -> None:
    att = _attended(s, t, causal, window)
    BQ, BK = block_q, block_k
    for qb in range(-(-s // BQ)):
        first, end, masked = tflash.key_tiles(qb, s, t, causal, window, block_q=BQ, block_k=BK)
        rows = att[qb * BQ:min(qb * BQ + BQ, s)]
        assert 0 <= first < end <= -(-t // BK) and len(masked) == end - first
        keys = np.flatnonzero(rows.any(axis=0))
        # every attended key is in a visited tile, and the first and last
        # visited tiles each hold one
        assert keys[0] // BK == first and keys[-1] // BK == end - 1, (qb, first, end)
        no_key = causal and window is not None and qb * BQ + len(rows) - 1 >= t - 1 + window
        if no_key:
            assert (first, end) == (0, -(-t // BK)) and all(masked)
        for j, m in zip(range(first, end), masked):
            tile = rows[:, j * BK:(j + 1) * BK]
            if not m:  # an unmasked tile lies inside T and every row attends all of it
                assert (j + 1) * BK <= t and tile.all(), (qb, j)


@pytest.mark.parametrize("s,t", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_causal_tiles_cover_exactly_the_attended_keys(s, t, window):
    _check_blocks(s, t, True, window)


@pytest.mark.parametrize("s,t", SIZES)
def test_non_causal_visits_every_tile(s, t):
    _check_blocks(s, t, False, None)
    for qb in range(-(-s // BQ)):
        first, end, masked = tflash.key_tiles(qb, s, t, False, None)
        assert (first, end) == (0, -(-t // BK))
        assert masked == [j * BK + BK > t for j in range(first, end)]


@pytest.mark.parametrize(
    "s,t,causal,window",
    [(300, 100, True, 20), (200, 200, True, 37), (77, 45, True, None), (129, 300, True, 1),
     (1, 300, False, None), (257, 130, True, 64)],
)
def test_tile_walk_matches_the_dense_softmax(s, t, causal, window):
    _tile_walk(s, t, causal, window, BQ, BK)


def _tile_walk(s, t, causal, window, BQ, BK):
    """Walk the schedule in float64, masking only the tiles it marks,
    against the dense softmax."""
    rng = np.random.default_rng(s * t)
    sc = rng.standard_normal((s, t)) * 3
    v = rng.standard_normal((t, 5))
    qpos = np.arange(s)[:, None]
    want_s = sc.copy()
    if causal:
        bad = np.arange(t)[None, :] > qpos
        if window is not None:
            bad |= qpos - np.arange(t)[None, :] >= window
        want_s[bad] = -1e30
    p = np.exp(want_s - want_s.max(axis=1, keepdims=True))
    want = (p / p.sum(axis=1, keepdims=True)) @ v
    got = np.empty_like(want)
    for qb in range(-(-s // BQ)):
        r0, r1 = qb * BQ, min(qb * BQ + BQ, s)
        m = np.full(r1 - r0, -1e30)
        l = np.zeros(r1 - r0)
        acc = np.zeros((r1 - r0, v.shape[1]))
        first, end, masked = tflash.key_tiles(qb, s, t, causal, window, block_q=BQ, block_k=BK)
        for j, need in zip(range(first, end), masked):
            k = np.arange(j * BK, j * BK + BK)
            if need:
                x = np.where(k < t, sc[r0:r1, np.minimum(k, t - 1)], -np.inf)
                if causal:
                    q = np.arange(r0, r1)[:, None]
                    bad = (k[None, :] > q) | (q - k[None, :] >= (window or 2**31 - 1))
                    x = np.where(bad & (k < t), -1e30, x)
                vt = v[np.minimum(k, t - 1)]
            else:
                x, vt = sc[r0:r1, k], v[k]
            m_new = np.maximum(m, x.max(axis=1))
            alpha = np.exp(m - m_new)
            pe = np.exp(x - m_new[:, None])
            l = l * alpha + pe.sum(axis=1)
            acc = acc * alpha[:, None] + pe @ vt
            m = m_new
        got[r0:r1] = acc / np.maximum(l, 1e-30)[:, None]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s,t", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_f32_causal_tiles_cover_exactly_the_attended_keys(s, t, window):
    _check_blocks(s, t, True, window, **F32)


@pytest.mark.parametrize("s,t", SIZES)
def test_f32_non_causal_visits_every_tile(s, t):
    _check_blocks(s, t, False, None, **F32)
    for qb in range(-(-s // F32["block_q"])):
        assert tflash.key_tiles(qb, s, t, False, None, **F32)[:2] == (0, -(-t // 32))


@pytest.mark.parametrize(
    "s,t,causal,window",
    [(300, 100, True, 20), (200, 200, True, 37), (77, 45, True, None), (129, 300, True, 1),
     (1, 300, False, None), (257, 130, True, 64), (333, 517, True, 100), (2048, 2048, True, 1000)],
)
def test_f32_tile_walk_matches_the_dense_softmax(s, t, causal, window):
    _tile_walk(s, t, causal, window, F32["block_q"], F32["block_k"])


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dh,dv", [(64, 64), (64, 128), (128, 256), (256, 64), (256, 256)])
def test_bf16_widths_the_kernel_takes(dh, dv):
    q, k, v = _bf16(2, 5, 4, dh), _bf16(2, 7, 2, dh), _bf16(2, 7, 2, dv)
    assert tflash.check_inputs(q, k, v) == (2, 5, 7, 4, 2, dh, dv)


@pytest.mark.parametrize("dh,dv,name", [(32, 32, "dh"), (96, 128, "dh"), (128, 192, "dv"),
                                        (64, 4, "dv")])
def test_bf16_widths_it_refuses_are_named(dh, dv, name):
    q, k, v = _bf16(1, 3, 2, dh), _bf16(1, 3, 2, dh), _bf16(1, 3, 2, dv)
    with pytest.raises(ValueError, match=f"{name} must be one of \\(64, 128, 256\\)"):
        tflash.check_inputs(q, k, v)
    # float32 keeps the CUDA-core kernel's rule: multiples of 4 up to 256
    assert tflash.check_inputs(q.float(), k.float(), v.float())[-2:] == (dh, dv)


def test_bf16_needs_16_byte_aligned_pointers():
    flat = torch.zeros(1 * 3 * 2 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(1, 3, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = _bf16(1, 3, 2, 64)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        tflash.check_inputs(q, k, k)
    q32 = torch.zeros(1 * 3 * 2 * 64 + 1)[1:].view(1, 3, 2, 64)  # float32 has no such rule
    assert q32.data_ptr() % 16 and tflash.check_inputs(q32, k.float(), k.float())[0] == 1


# The bfloat16 backward's schedules (csrc/flash_attn_bwd.cu), at each of its
# block shapes: dq blocks of 128 or 64 rows, dk/dv blocks of 128 keys (two
# warpgroups of 64) or 64 (both warpgroups on the same keys).
BWD_BLOCKS = sorted({tflash.bwd_blocks(dh, dv) for dh in (64, 128, 256) for dv in (64, 128, 256)})


def _sees(s: int, t: int, causal: bool, window) -> np.ndarray:
    """(S, T) bool: the pairs that attend, rows with no key attending none."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    if not causal:
        return np.ones((s, t), bool)
    ok = k <= q
    if window is not None:
        ok &= q - k < window
    return ok


def _check_bwd(s: int, t: int, causal: bool, window, block_q: int, block_k: int) -> None:
    ok = _sees(s, t, causal, window)
    no_key = ~ok.any(axis=1)
    for qb in range(-(-s // block_q)):
        first, end, masked = tflash.bwd_key_tiles(qb, s, t, causal, window, block_q=block_q)
        rows = ok[qb * block_q:min(qb * block_q + block_q, s)]
        keys = np.flatnonzero(rows.any(axis=0))
        assert len(masked) == end - first
        if not len(keys):  # no row of the block has a key: dq is 0
            assert first == end, (qb, first, end)
            continue
        assert keys[0] // 64 == first and keys[-1] // 64 == end - 1, (qb, first, end)
        for j, m in zip(range(first, end), masked):
            if not m:
                assert (j + 1) * 64 <= t and rows[:, j * 64:(j + 1) * 64].all(), (qb, j)
    for kb in range(-(-t // block_k)):
        main, none = tflash.bwd_query_tiles(kb, s, t, causal, window, block_k=block_k)
        k0, k1 = kb * block_k, min(kb * block_k + block_k, t)
        seen = np.flatnonzero(ok[:, k0:k1].any(axis=1))
        if len(seen):
            assert seen[0] // 64 == main.start and seen[-1] // 64 == main.stop - 1, (kb, main)
        else:
            assert len(main) == 0, (kb, main)
        lost = np.flatnonzero(no_key)
        assert list(none) == (list(range(lost[0] // 64, -(-s // 64))) if len(lost) else []), kb
        for w in range(block_k // 64):
            kw0 = k0 + (64 * w if block_k == 128 else 0)
            for j in main:
                masked, skipped = tflash.bwd_pair(kw0, 64 * j, causal, window)
                pair = ok[64 * j:min(64 * j + 64, s), kw0:min(kw0 + 64, t)]
                assert not (skipped and pair.any()), (kb, w, j)
                assert masked or pair.all(), (kb, w, j)


@pytest.mark.parametrize("block_q,block_k", BWD_BLOCKS)
@pytest.mark.parametrize("s,t", SIZES)
@pytest.mark.parametrize("causal,window", [(False, None)] + [(True, w) for w in WINDOWS])
def test_bwd_tiles_cover_exactly_the_attended_pairs(s, t, causal, window, block_q, block_k):
    _check_bwd(s, t, causal, window, block_q, block_k)


def test_bwd_blocks_follow_the_widths():
    assert tflash.bwd_blocks(64, 64) == tflash.bwd_blocks(128, 128) == (128, 128)
    assert tflash.bwd_blocks(64, 256) == tflash.bwd_blocks(256, 128) == (128, 64)
    assert tflash.bwd_blocks(256, 256) == (64, 64)
