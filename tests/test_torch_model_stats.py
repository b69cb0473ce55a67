"""The port's model statistics (``launch/model_stats.py``: a ``Model`` on the
``meta`` device, summed over the JAX leaves) against the JAX package's
(``jax.eval_shape``) for every architecture: equal counts."""
import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.launch import model_stats as jstats
from repro_torch.configs import get_config as tget
from repro_torch.launch import model_stats as tstats


@pytest.fixture
def once(monkeypatch):
    """The reference's counts each trace ``abstract_params``; trace it once
    an architecture (the same function, memoized)."""
    seen = {}
    trace = jstats.abstract_params

    def memo(cfg):
        if cfg.name not in seen:
            seen[cfg.name] = trace(cfg)
        return seen[cfg.name]

    monkeypatch.setattr(jstats, "abstract_params", memo)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_the_reference(arch, once):
    assert tstats.count_params(tget(arch)) == jstats.count_params(jget(arch))
    assert tstats.count_active_params(tget(arch)) == jstats.count_active_params(jget(arch))


def test_abstract_params_are_the_jax_leaves():
    import jax

    leaves = jax.tree_util.tree_leaves_with_path(jstats.abstract_params(jget("deepseek-v2-236b")))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(x.shape)
            for path, x in leaves}
    assert tstats.abstract_params(tget("deepseek-v2-236b")) == want
