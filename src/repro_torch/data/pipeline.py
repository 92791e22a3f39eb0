"""Synthetic data pipeline: deterministic, shardable, host-streamed.

Port of `src/repro/data/pipeline.py` (numpy, so the port keeps its own
copy): `PipelineConfig` (:21), `TokenPipeline` (:32) and `make_lm_batch`
(:73) give the reference's arrays bit for bit for the same seed and step.

Each host produces ONLY its shard of the global batch, deterministically
from (step, host_id), so restarts resume mid-epoch without coordination.
The corpus is a mixture of Markov-chain "documents", so batches have
learnable structure and a falling loss is a meaningful smoke signal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["TokenPipeline", "PipelineConfig", "make_lm_batch"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    order: int = 1            # Markov order of the synthetic corpus


class TokenPipeline:
    """Deterministic sharded batch stream.

    `batch(step)` returns this host's shard: (global_batch/num_hosts, seq+1)
    tokens; the +1 column provides next-token labels.  Calling it twice with
    the same step gives identical data (restart-safe); no host sees another
    host's shard.
    """

    def __init__(self, cfg: PipelineConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} is not a "
                             f"multiple of {cfg.num_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # small Markov transition table, shared across hosts (same corpus)
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab, 512)   # transition support (keeps table tiny)
        logits = rng.standard_normal((v, v)) * 2.0
        self._probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self._support = v

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        v = self._support
        out = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        state = rng.integers(0, v, size=self.local_batch)
        out[:, 0] = state
        # vectorized Markov walk via inverse-CDF sampling
        cdf = np.cumsum(self._probs, axis=1)
        for t in range(1, cfg.seq_len + 1):
            u = rng.random(self.local_batch)
            state = (cdf[state] < u[:, None]).sum(axis=1)
            out[:, t] = state
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_lm_batch(tokens_plus_one: np.ndarray, *, frontend: str = "tokens",
                  d_model: Optional[int] = None, mrope: bool = False,
                  seed: int = 0) -> dict:
    """(B, S+1) host tokens -> model batch dict of numpy arrays.

    For `frontend="embeds"` (audio/VLM stubs) the tokens are replaced by
    random frame/patch embeddings of width d_model (seeded by ``seed``)
    while labels stay token ids; ``mrope`` gives (B, 3, S) positions.
    """
    tok = tokens_plus_one[:, :-1]
    labels = tokens_plus_one[:, 1:].astype(np.int32)
    B, S = tok.shape
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    batch = {"labels": labels}
    if frontend == "tokens":
        batch["tokens"] = tok.astype(np.int32)
    else:
        rng = np.random.default_rng(seed)
        batch["embeds"] = rng.standard_normal((B, S, d_model)).astype(np.float32)
    if mrope:
        batch["pos"] = np.broadcast_to(pos[:, None, :], (B, 3, S)).copy()
    else:
        batch["pos"] = pos
    return batch
