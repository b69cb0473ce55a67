"""The port's hybrid, attention-free and encoder-decoder serving against
``repro.models.model`` on the CPU: Hymba-1.5B, RWKV6-1.6B and Whisper-small.

``init_params`` weights of each reduced config (float32) are carried across
by ``params_from_jax`` (whisper's stacked ``enc_layers`` split like
``layers``); then ``prefill`` and one ``decode_step`` run in both packages
on the same numpy-seeded tokens (and, for whisper, frame embeddings), and
the logits and every cache leaf are compared.  Hymba's prompt (24 tokens)
is longer than the reduced window (16), so its local layer masks; RWKV's
prompt of 64 tokens takes the chunked WKV form and one of 24 the
sequential scan.  The port's full-sequence attention goes through
``ops.flash_attention`` (its plain version on the CPU): once a layer for
hymba, three times a layer (encoder, decoder self, cross) for whisper,
never for RWKV.

Tolerance: logits and caches within rtol 1e-4 / atol 1e-5, that of
``tests/test_torch_model_serve.py``: both run in float32, and the matmuls,
softmax sums and recurrences run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.models import model as jmodel
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["hymba-1.5b", "rwkv6-1.6b", "whisper-small"]
B, S, CACHE = 2, 24, 28
# Full-sequence attention calls of a prefill, per layer of the reduced config.
FLASH_PER_LAYER = {"hybrid": 1, "ssm": 0, "audio": 3}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(JAX config, port config, JAX params, port model)."""
    jcfg, tcfg = jget(request.param).reduced(), tget(request.param).reduced()
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_cache(tc, jc):
    assert tc.keys() == jc.keys() == {"scan"}
    assert tc["scan"].keys() == jc["scan"].keys()
    for name, t in tc["scan"].items():
        want = jc["scan"][name]
        assert tuple(t.shape) == want.shape, name
        assert t.dtype == torch.float32 and want.dtype == jnp.float32, name
        np.testing.assert_allclose(t.numpy(), np.asarray(want), **TOL, err_msg=name)


def _count_flash(monkeypatch):
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    return calls


def _prefill_and_decode_match_jax(arch, monkeypatch, s):
    jcfg, tcfg, jp, tp = arch
    cache_len = s + 4
    batch = _batch(tcfg, s=s)
    jl, jc = jmodel.prefill(jp, _jax(batch), jcfg, cache_len=cache_len)
    calls = _count_flash(monkeypatch)
    tops.reset_launch_counts()
    tl, tc = tmodel.prefill(tp, _torch(batch), tcfg, cache_len=cache_len)
    assert tops.launch_counts()["flash_attention"] == 0  # the plain version on the CPU
    assert len(calls) == FLASH_PER_LAYER[tcfg.family] * tcfg.num_layers
    if tcfg.family == "hybrid":  # layer 0 global, layer 1 local
        assert [c["window"] for c in calls] == [int(w) for w in tfm.layer_windows(tcfg)]
    if tcfg.family == "audio":  # the encoder and the cross-attention attend every key
        assert [c["causal"] for c in calls] == [False] * tcfg.encoder_layers + [
            True, False] * tcfg.num_layers
    assert tl.shape == (B, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)

    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    calls.clear()
    jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(s), jcfg)
    tl, tc2 = tmodel.decode_step(tp, torch.from_numpy(nxt), tc, s, tcfg)
    assert tc2 is tc and not calls  # updated in place; decode stays plain
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)


def test_prefill_and_decode_match_jax(arch, monkeypatch):
    _prefill_and_decode_match_jax(arch, monkeypatch, S)


def test_rwkv_chunked_prefill_and_decode_match_jax(monkeypatch):
    # 64 tokens: the chunked WKV form in both packages.
    jcfg, tcfg = jget("rwkv6-1.6b").reduced(), tget("rwkv6-1.6b").reduced()
    jp = jmodel.init_params(jax.random.key(1), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _prefill_and_decode_match_jax((jcfg, tcfg, jp, tp), monkeypatch, 2 * tssm.WKV_CHUNK)


def test_decode_from_an_initialised_cache(arch):
    # decode_step on init_decode_cache (zeros; whisper's cross K and V
    # zero too), in both packages.
    jcfg, tcfg, jp, tp = arch
    tok = _batch(tcfg, seed=5)["tokens"][:, 0]
    jc = jmodel.init_decode_cache(jp, jcfg, B, CACHE)
    tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
    jl, jc = jmodel.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(3), jcfg)
    tl, tc = tmodel.decode_step(tp, torch.from_numpy(tok), tc, 3, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)


def test_init_decode_cache_layout(arch):
    jcfg, tcfg, jp, tp = arch
    jc = jmodel.init_decode_cache(jp, jcfg, B, CACHE)
    tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
    assert tc.keys() == jc.keys() == {"scan"}
    assert tc["scan"].keys() == jc["scan"].keys()
    for name, t in tc["scan"].items():
        assert tuple(t.shape) == jc["scan"][name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(jc["scan"][name].dtype), name
        assert not bool(t.any()), name


def test_init_decode_cache_dtypes_in_bfloat16():
    # The recurrent states stay float32 in a bfloat16 model, as in the reference.
    for name in ARCHS:
        jcfg = dataclasses.replace(jget(name).reduced(), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        tcfg = dataclasses.replace(tget(name).reduced(), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        jc = jmodel.init_decode_cache(None, jcfg, B, CACHE)
        tp = tmodel.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
        for leaf, t in tc["scan"].items():
            assert tuple(t.shape) == jc["scan"][leaf].shape, (name, leaf)
            assert str(t.dtype).removeprefix("torch.") == str(jc["scan"][leaf].dtype), (name, leaf)


def test_prefill_then_decode_equals_longer_prefill(arch):
    # logits(prefill over S) against logits(prefill over S-1, then one
    # decode_step at S-1), as tests/test_arch_smoke.py checks the JAX package.
    _, tcfg, _, tp = arch
    batch = _torch(_batch(tcfg, seed=3))
    full, _ = tmodel.prefill(tp, batch, tcfg, cache_len=CACHE)
    short = {**batch, "tokens": batch["tokens"][:, :-1]}
    _, cache = tmodel.prefill(tp, short, tcfg, cache_len=CACHE)
    step, _ = tmodel.decode_step(tp, batch["tokens"][:, -1], cache, S - 1, tcfg)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def test_rwkv_chunked_prefill_then_scan_decode():
    # The chunked form over 64 tokens against the sequential scan over 63
    # plus a decode step: the two forms and the state hand-off agree.
    cfg = tget("rwkv6-1.6b").reduced()
    tp = tmodel.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    tok = torch.from_numpy(_batch(cfg, seed=4, s=2 * tssm.WKV_CHUNK)["tokens"])
    full, _ = tmodel.prefill(tp, {"tokens": tok}, cfg)
    _, cache = tmodel.prefill(tp, {"tokens": tok[:, :-1]}, cfg)
    step, _ = tmodel.decode_step(tp, tok[:, -1], cache, tok.shape[1] - 1, cfg)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=1e-4, atol=1e-5)


def test_whisper_decode_past_the_cache_clamps():
    # Past the cache the position row and the K/V row clamp to the last, as
    # lax.dynamic_slice_in_dim and dynamic_update_slice clamp them.
    jcfg, tcfg = jget("whisper-small").reduced(), tget("whisper-small").reduced()
    jp = jmodel.init_params(jax.random.key(4), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batch = _batch(tcfg, seed=6)
    jl, jc = jmodel.prefill(jp, _jax(batch), jcfg, cache_len=S)
    tl, tc = tmodel.prefill(tp, _torch(batch), tcfg, cache_len=S)
    tok = batch["tokens"][:, 0]
    jl, jc = jmodel.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(S + 3), jcfg)
    tl, tc = tmodel.decode_step(tp, torch.from_numpy(tok), tc, S + 3, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)


def test_converter_maps_leaves_one_to_one(arch):
    jcfg, tcfg, jp, tp = arch
    flat = dict(convert._flatten(jax.tree.map(np.asarray, jp)))
    params = dict(tp.named_parameters())
    n_split = 0
    for name, arr in flat.items():
        head, _, rest = name.partition(".")
        if head in convert.STACKED:
            assert arr.shape[0] == len(getattr(tp, head)), name
            for i in range(arr.shape[0]):
                np.testing.assert_array_equal(params[f"{head}.{i}.{rest}"].numpy(), arr[i])
            n_split += arr.shape[0]
        else:
            np.testing.assert_array_equal(params[name].numpy(), arr)
            n_split += 1
    assert len(params) == n_split
    if tcfg.family == "audio":
        assert any(n.startswith("enc_layers.1.") for n in params)


def test_converter_keeps_float32_leaves_of_a_bfloat16_model():
    # RWKV's w0 and u and Mamba's dt_bias, a_log and d_skip are float32 in
    # a bfloat16 JAX tree; the port's modules hold them in float32 too.
    for name, f32 in (("rwkv6-1.6b", {"w0", "u"}), ("hymba-1.5b", {"dt_bias", "a_log", "d_skip"})):
        jcfg = dataclasses.replace(jget(name).reduced(), param_dtype="bfloat16")
        tcfg = dataclasses.replace(tget(name).reduced(), param_dtype="bfloat16")
        tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0), jcfg))
        tp = convert.params_from_jax(tree, tcfg, "cpu")
        got = {n.rsplit(".", 1)[1] for n, p in tp.named_parameters() if p.dtype == torch.float32}
        assert got == f32, (name, got)


def test_converter_refuses_a_mismatched_tree(arch):
    _, tcfg, jp, _ = arch
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]["bias" if tfm.uses_layer_norm(tcfg) else "scale"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_jax(tree, tcfg, "cpu")


def test_init_params_on_the_cpu(arch):
    # Random init through the port's own generator: the same tree of names,
    # shapes and dtypes as the JAX package's.
    _, tcfg, _, tp = arch
    fresh = tmodel.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()}
    assert shapes == {n: (p.shape, p.dtype) for n, p in tp.named_parameters()}


def test_registry_equals_the_jax_registry():
    # The same ten ids in the JAX order; every field equal but the JAX
    # package's two use_pallas_* switches, which the port does not have.
    assert T_ARCH_IDS == J_ARCH_IDS and len(T_ARCH_IDS) == 10
    for name in J_ARCH_IDS:
        want = dataclasses.asdict(jget(name))
        assert want.pop("use_pallas_router") is False
        assert want.pop("use_pallas_attention") is False
        assert dataclasses.asdict(tget(name)) == want, name
        assert dataclasses.asdict(tget(name).reduced()) == {
            k: v for k, v in dataclasses.asdict(jget(name).reduced()).items()
            if not k.startswith("use_pallas_")}, name
