"""The jsaq_route kernel's level fill, on the CPU.

``kernels/jsaq_route.jsaq_route_levels`` runs the rounds of
``csrc/jsaq_route.cu`` in plain PyTorch: the row minimum, a histogram of the
levels below N, the fill level, one round per distinct level that takes a
job, and int32 wrapping as the chain does it.  A round placed wrong gives
wrong routes with no error, so the mirror is held bit for bit against the
sequential chain (``ref.jsaq_route_ref``) and against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs, and its rounds
against the bound ``floor((1 + sqrt(1 + 8 N)) / 2)``.  The cases are the
card tests' (``tests/test_torch_cuda.py``: ``JSAQ_CASES``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import jsaq_route as tjsaq
from repro_torch.kernels import ref as tref
from test_torch_cuda import JSAQ_CASES as CASES
from test_torch_cuda import jsaq_case as _rows

def _chain(q: np.ndarray, n: int):
    """The sequential chain in numpy int64, wrapped to int32 after each job.
    Also returns each row's rounds: the levels that take a job (counted
    from the row minimum, without the wrap) at which some server starts."""
    start = q.astype(np.int64)
    q = start.copy()
    idx = np.zeros((q.shape[0], n), np.int64)
    rounds = []
    for r in range(q.shape[0]):
        levels = set()
        lifted = start[r] - start[r].min()
        for j in range(n):
            i = int(np.argmin(q[r]))
            idx[r, j] = i
            levels.add(int(lifted[i]))
            lifted[i] += 1
            q[r, i] = (q[r, i] + 1 + 2**31) % 2**32 - 2**31
        rounds.append(len(levels & set((start[r] - start[r].min()).tolist())))
    return idx, q, rounds


@pytest.mark.parametrize("case", CASES)
def test_levels_equal_the_chain_and_respect_the_round_bound(case):
    q, n = _rows(case)
    idx, q_out, rounds = tjsaq.jsaq_route_levels(torch.from_numpy(q), n)
    want_idx, want_q = tref.jsaq_route_ref(torch.from_numpy(q), n)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    np.testing.assert_array_equal(q_out.numpy(), want_q.numpy())
    chain_idx, chain_q, chain_rounds = _chain(q, n)
    np.testing.assert_array_equal(idx.numpy(), chain_idx)
    np.testing.assert_array_equal(q_out.numpy(), chain_q)
    assert rounds.tolist() == chain_rounds
    bound = math.floor((1 + math.sqrt(1 + 8 * n)) / 2)
    assert tjsaq.jsaq_max_rounds(n) <= bound
    assert rounds.shape == (q.shape[0],) and int(rounds.max()) <= tjsaq.jsaq_max_rounds(n)
    if case == "staircase_i":  # the worst case: every level adds a server
        assert int(rounds.max()) == tjsaq.jsaq_max_rounds(n) == 23
    if case == "smoke_row":
        assert rounds.tolist() == [5, 5, 5, 5]


# The Pallas kernel refuses N = 0 (a zero-width output block); the plain
# chain above covers that case.
@pytest.mark.parametrize("case", [c for c in CASES if c != "n0"])
def test_levels_equal_the_jax_kernel(case):
    q, n = _rows(case)
    idx, q_out, _ = tjsaq.jsaq_route_levels(torch.from_numpy(q), n)
    j_idx, j_q = jops.jsaq_route(jnp.asarray(q), n, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(q_out.numpy(), np.asarray(j_q))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 6, 7, 255, 256, 4096])
def test_max_rounds_is_the_largest_d_with_d_choose_2_below_n(n):
    d = tjsaq.jsaq_max_rounds(n)
    assert d * (d - 1) // 2 <= max(n - 1, 0) and (n == 0 or (d + 1) * d // 2 > n - 1)
    assert d <= math.floor((1 + math.sqrt(1 + 8 * n)) / 2)


def test_levels_refuse_jobs_without_servers():
    with pytest.raises(ValueError, match="cannot route 3 jobs over 0 servers"):
        tjsaq.jsaq_route_levels(torch.zeros((2, 0), dtype=torch.int32), 3)
