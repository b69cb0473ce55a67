"""The port's MoE router against the JAX package's Pallas router.

On the CPU ``repro_torch.kernels.ops.moe_route`` runs the plain PyTorch
version (``ref.moe_route_ref``); it is held against the Pallas kernel run
in interpret mode (``repro.kernels.ops.moe_route(..., interpret=True)``)
and against the JAX oracle, on the same numpy-seeded inputs.  The expert
ids and counts must be equal; the combine weights must agree within
rtol 1e-5 / atol 1e-6, the JAX package's own tolerance between its kernel
and its oracle (``tests/test_kernels.py``), since the softmax sums run in
another order.  The port also returns each (token, slot)'s position in its
expert's capacity buffer (``ref.moe_positions_ref``);
it must equal, bit for bit, the reference's own formula
(``repro/models/ffn.py:112-114``: one-hot, cumsum, sum) run in JAX on
JAX's ids.  The CUDA kernel is held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import moe_route as tmoe
from repro_torch.kernels import ops as tops
from repro_torch.models import ffn as tffn

RTOL, ATOL = 1e-5, 1e-6
# One compiled program per shape is cheaper than the oracle's ops one by one.
_jref_route = jax.jit(jref.moe_route_ref, static_argnums=(2, 3))


@functools.partial(jax.jit, static_argnums=1)
def _jax_positions(idx, e):
    """The reference's positions (``repro/models/ffn.py:110-114``)."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    return jnp.sum(pos * onehot, axis=1)


def _inputs(t, e, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    bias = rng.standard_normal(e).astype(np.float32)
    return logits, bias


def _both(logits: np.ndarray, bias: np.ndarray, k: int, gate_fn="softmax", dtype="float32"):
    """Route with the port and with the Pallas kernel and the JAX oracle;
    assert they agree and return the port's (idx, weights, counts) as numpy."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jl, jb = jnp.asarray(logits, jdt), jnp.asarray(bias)
    tl = torch.from_numpy(logits).to(tdt)
    got = [x.numpy() for x in tops.moe_route(tl, torch.from_numpy(bias), k, gate_fn=gate_fn)]
    for want in (
        jops.moe_route(jl, jb, k, gate_fn=gate_fn, interpret=True),
        _jref_route(jl, jb, k, gate_fn),
    ):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32 and got[2].dtype == np.int32
    return got[:3]


# Every E in {16, 64, 160, 256} with every k in {1, 2, 6, 8}; T cycles
# over a tile multiple, a ragged count (the JAX wrapper pads it, the port
# masks by bound) and two tiles.
_EK = [(e, k) for e in (16, 64, 160, 256) for k in (1, 2, 6, 8)]
CASES = [
    ((128, 200, 256)[i % 3], e, k, ("float32", "bfloat16")[i % 2])
    for i, (e, k) in enumerate(_EK)
]


class TestMoeRoute:
    @pytest.mark.parametrize("t,e,k,dtype", CASES)
    def test_matches_pallas_and_oracle(self, t, e, k, dtype):
        logits, bias = _inputs(t, e, seed=t * 1000 + e * 10 + k)
        _, _, counts = _both(logits, bias, k, dtype=dtype)
        assert int(counts.sum()) == t * k

    @pytest.mark.parametrize("gate_fn", ["softmax", "sigmoid"])
    @pytest.mark.parametrize("t,e,k", [(128, 32, 4), (200, 256, 8)])
    def test_gate_fns(self, gate_fn, t, e, k):
        logits, bias = _inputs(t, e, seed=e + k)
        _both(logits, bias, k, gate_fn=gate_fn)

    def test_all_ties_lowest_index_first(self):
        logits = np.zeros((128, 16), np.float32)
        idx, w, counts = _both(logits, np.zeros(16, np.float32), 4)
        np.testing.assert_array_equal(idx, np.tile(np.arange(4, dtype=np.int32), (128, 1)))
        np.testing.assert_allclose(w, 0.25, rtol=RTOL)
        np.testing.assert_array_equal(counts, [128] * 4 + [0] * 12)

    def test_large_bias_steers_selection_not_weights(self):
        logits, _ = _inputs(200, 8, seed=3)
        bias = np.zeros(8, np.float32)
        bias[0] = 1e9
        idx, w, counts = _both(logits, bias, 2)
        assert counts[0] == 0 and (idx != 0).all()
        # Weights come from the unbiased softmax of the chosen experts.
        gates = torch.softmax(torch.from_numpy(logits), dim=1).numpy()
        chosen = np.take_along_axis(gates, idx, axis=1)
        np.testing.assert_allclose(w, chosen / chosen.sum(1, keepdims=True), rtol=RTOL)

    @pytest.mark.parametrize("t", [1, 7])
    def test_any_token_count(self, t):
        # The TPU wrapper pads to 128 tokens and subtracts phantom counts;
        # the port takes any T.
        logits, bias = _inputs(t, 160, seed=t)
        _, w, counts = _both(logits, bias, 6)
        assert int(counts.sum()) == 6 * t
        np.testing.assert_allclose(w.sum(1), 1.0, rtol=RTOL)

    def test_k_equal_to_e(self):
        logits, bias = _inputs(128, 8, seed=5)
        idx, _, counts = _both(logits, bias, 8)
        np.testing.assert_array_equal(np.sort(idx, axis=1), np.tile(np.arange(8), (128, 1)))
        np.testing.assert_array_equal(counts, 128)

    def test_refuses_bad_arguments(self):
        logits = torch.zeros((4, 8))
        bias = torch.zeros(8)
        for k in (0, 9):
            with pytest.raises(ValueError, match="top_k"):
                tops.moe_route(logits, bias, k)
        with pytest.raises(ValueError, match="gate_fn"):
            tops.moe_route(logits, bias, 2, gate_fn="relu")
        with pytest.raises(ValueError, match="CUDA tensor"):
            tmoe.moe_route_cuda(logits, bias, 2)

    def test_cpu_path_launches_nothing(self):
        tops.reset_launch_counts()
        logits, bias = _inputs(16, 8, seed=0)
        tops.moe_route(torch.from_numpy(logits), torch.from_numpy(bias), 2)
        assert tops.launch_counts()["moe_route"] == 0


def _with_positions(logits: np.ndarray, bias: np.ndarray, k: int, gate_fn="softmax"):
    """``_both``'s comparison, and the positions against the reference's
    formula on JAX's ids (Pallas kernel and oracle), bit for bit.  Returns
    the port's four outputs as numpy."""
    jl, jb = jnp.asarray(logits), jnp.asarray(bias)
    got = tops.moe_route(torch.from_numpy(logits), torch.from_numpy(bias), k, gate_fn=gate_fn)
    got = [x.numpy() for x in got]
    for want in (
        jops.moe_route(jl, jb, k, gate_fn=gate_fn, interpret=True),
        _jref_route(jl, jb, k, gate_fn),
    ):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        np.testing.assert_array_equal(got[3], np.asarray(_jax_positions(want[0], logits.shape[1])))
    assert got[3].dtype == np.int32 and got[3].shape == (logits.shape[0] * k,)
    return got


# k by E: the DeepSeek-V2 and -V3 shapes, and a ragged E.
_K_OF = {33: 5, 160: 6, 256: 8}


class TestMoePositions:
    @pytest.mark.parametrize("e", sorted(_K_OF))
    @pytest.mark.parametrize("t", [1, 4, 77, 2048])
    def test_matches_the_reference_formula(self, t, e):
        logits, bias = _inputs(t, e, seed=7 * t + e)
        k = _K_OF[e]
        idx, _, counts, pos = _with_positions(logits, bias, k,
                                              gate_fn="sigmoid" if e == 256 else "softmax")
        # Each expert's positions are 0, 1, ..., counts - 1 in flat order.
        flat = idx.reshape(-1)
        for x in np.unique(flat):
            np.testing.assert_array_equal(pos[flat == x], np.arange(counts[x]))

    def test_skewed_gate_overflows_capacity(self):
        t, e, k = 512, 160, 6
        logits, bias = _inputs(t, e, seed=11)
        logits[:, :4] += 6.0  # most tokens want experts 0-3
        _, _, counts, pos = _with_positions(logits, bias, k)
        cap = tffn._capacity(t, k, e, 1.0)
        assert counts.max() > cap and int((pos >= cap).sum()) == int(
            np.clip(counts - cap, 0, None).sum())

    @pytest.mark.parametrize("t,e,k", [(64, 8, 3), (77, 160, 6)])
    def test_repeated_expert_counts_in_slot_order(self, t, e, k):
        # Every score but k - 1 lies below -1e30, so the last sweep takes a
        # masked expert again; the positions count both slots, in order.
        logits, _ = _inputs(t, e, seed=e)
        rng = np.random.default_rng(e + 1)
        bias = np.full(e, 2e30, np.float32)
        bias[rng.choice(e, k - 1, replace=False)] = 0.0
        idx, _, counts, pos = _with_positions(logits, bias, k)
        assert (idx[:, -1:] == idx[:, :-1]).any(1).all()
        assert int(counts.sum()) == t * k

    def test_repeats_as_in_the_reference(self):
        # E = 8, k = 3, all but experts 1 and 5 out of reach: [5, 1, 1].
        logits, _ = _inputs(16, 8, seed=1)
        bias = np.full(8, 2e30, np.float32)
        bias[1], bias[5] = 0.0, -10.0
        idx, _, _, pos = _with_positions(logits, bias, 3)
        np.testing.assert_array_equal(idx, np.tile([5, 1, 1], (16, 1)))
        np.testing.assert_array_equal(pos.reshape(16, 3), np.stack(
            [np.arange(16), 2 * np.arange(16), 2 * np.arange(16) + 1], 1))
