"""Deterministic synthetic data pipeline: sharded, restartable, skippable.

Port of ``repro/data/pipeline.py`` in numpy (the batches are made on the
host and moved to the device by the train step).  Tokens are a pure
function of (seed, global step, position) through a counter-mode hash, so
each data-parallel shard draws its own rows with no coordination, a
restart seeks to a step at no cost, and a re-shard keeps the global
stream.  The ids are Zipf-like over the vocabulary, with a BOS every 256
tokens and, half the time, the token 8 positions back echoed.

Two places follow the reference's arithmetic closely.  The hash multiplies
in uint32 with wrap-around (numpy's uint32 arrays wrap).  The Zipf map
takes ``u ** a`` in float32 in the reference (``jnp.power`` on a float32
``u``, since x64 is off); here ``u`` is cast to float32 the same way and
the power is taken in float64 and rounded to float32, which is the float32
power correctly rounded.  XLA's float32 ``pow`` is not always: on 5e6
uniform draws it differed in 3278 (0.07%) by an ulp, and a token changes
only where such an ulp crosses an integer boundary of ``u^a (V - 2)``:
``tests/test_torch_data.py`` states the count it finds.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    bos_id: int = 1


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """Counter-mode integer hash (xorshift-multiply, u32, wrapping)."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _zipf_map(u: np.ndarray, vocab: int, a: float) -> np.ndarray:
    """Map uniform [0,1) to a Zipf-ish vocab id via inverse power CDF."""
    u32 = u.astype(np.float32)
    powed = np.power(u32.astype(np.float64), np.float64(np.float32(a))).astype(np.float32)
    ids = powed * np.float32(vocab - 2)
    return (ids.astype(np.int32) + 2) % vocab  # reserve 0=pad, 1=bos


def global_batch_at(step: int, cfg: DataConfig) -> dict:
    """The full (global_batch, seq) batch for ``step``."""
    return shard_batch_at(step, cfg, dp_rank=0, dp_size=1)


def shard_batch_at(step: int, cfg: DataConfig, dp_rank: int, dp_size: int) -> dict:
    """This shard's rows of the global batch at ``step``: rows round-robin
    by global row id, so changing dp_size re-partitions the same stream."""
    if cfg.global_batch % dp_size:
        raise ValueError(f"global_batch {cfg.global_batch} % dp_size {dp_size} != 0")
    rows_local = cfg.global_batch // dp_size
    row_ids = dp_rank + dp_size * np.arange(rows_local)
    return _make_rows(step, row_ids, cfg)


def _make_rows(step: int, row_ids: np.ndarray, cfg: DataConfig) -> dict:
    s = cfg.seq_len
    # counter = ((step * GB + row) * (S+1) + position)
    base = (np.uint64(step) * np.uint64(cfg.global_batch) + row_ids.astype(np.uint64))
    counters = base[:, None] * np.uint64(s + 1) + np.arange(s + 1, dtype=np.uint64)
    counters = (counters + np.uint64(cfg.seed) * np.uint64(0x9E3779B9)) & np.uint64(
        0xFFFFFFFF
    )
    h = _hash_u32(counters.astype(np.uint32))
    u = h.astype(np.float64) / 2**32
    toks = _zipf_map(u, cfg.vocab_size, cfg.zipf_a)
    # documents: BOS every 256 tokens; learnable structure: echo token from
    # 8 positions back within the document half the time.
    pos = np.arange(s + 1)
    toks = np.where(pos[None, :] % 256 == 0, cfg.bos_id, toks)
    echo = np.roll(toks, 8, axis=1)
    use_echo = (h % 2 == 0) & (pos[None, :] % 256 >= 8)
    toks = np.where(use_echo, echo, toks).astype(np.int32)
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].copy(),
    }


class ShardedLoader:
    """Iterator facade with explicit step state (checkpointable)."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step

    def __next__(self) -> dict:
        b = shard_batch_at(self.step, self.cfg, self.dp_rank, self.dp_size)
        self.step += 1
        return b

    def __iter__(self):
        return self

    def skip_to(self, step: int):
        self.step = step
