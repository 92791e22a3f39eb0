"""The Plan IR — the one plan object every execution layer consumes.

Port of `src/repro/core/plan.py` (`Plan` with `fingerprint`, `save`,
`load`, the node-order plumbing and the device schedules).  A `Plan` is
the advisor's output and the runtime's input: the static group schedule
(forward and, optionally, the transposed backward pair), the tuned
`AggConfig`, the renumber permutation, and the extracted properties that
justified the choices.

The npz layout is the reference's (schema version 2), so a plan saved by
either package loads in the other.  `apply_delta` (mutable graphs) and
`shards` (sharded execution) wait for their slices; PyTorch runs eagerly,
so the reference's jit-argument convention has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional

import numpy as np

from repro_torch.core.extractor import GNNArchProps, GraphProps
from repro_torch.core.model import AggConfig
from repro_torch.core.partition import GroupPartition
from repro_torch.graphs.csr import CSRGraph

__all__ = ["Plan"]

_PARTITION_ARRAYS = ("nbrs", "edge_val", "local_node", "tile_node_block",
                     "tile_window", "edge_slot", "edge_pos")
_PARTITION_STATICS = ("gs", "gpt", "ont", "src_win", "num_nodes", "num_edges")


@dataclasses.dataclass
class Plan:
    """Everything needed to run aggregation for one graph (see module doc)."""

    graph: CSRGraph                    # possibly renumbered
    partition: GroupPartition
    config: AggConfig
    graph_props: Optional[GraphProps]
    arch: Optional[GNNArchProps]
    perm: Optional[np.ndarray]         # old->new node ids (None = identity)
    tuner: Optional[Any]
    stats: dict
    reduce_dim_first: bool             # §4.2 aggregation placement decision
    # the partition of the TRANSPOSED graph under the same config (the
    # training slice's backward schedule) + its edge permutation; carried
    # so npz files keep every field
    partition_bwd: Optional[GroupPartition] = None
    edge_perm_bwd: Optional[np.ndarray] = None
    epoch: int = 0

    # ---------------- identity / versioning ----------------

    def fingerprint(self) -> str:
        """Content hash of what the plan executes: the (plan-order) graph
        structure, its per-edge values, and the `AggConfig` (the
        reference's digest, byte for byte).  Cached per object."""
        cached = getattr(self, "_fingerprint_cache", None)
        if cached is None:
            h = hashlib.blake2b(digest_size=8)
            h.update(np.int64([self.graph.num_nodes,
                               self.graph.num_edges]).tobytes())
            h.update(np.ascontiguousarray(self.graph.indptr).tobytes())
            h.update(np.ascontiguousarray(self.graph.indices).tobytes())
            ev = self.partition.edge_values_csr()
            if ev is not None:
                h.update(np.ascontiguousarray(ev).tobytes())
            h.update(repr(self.config).encode())
            cached = h.hexdigest()
            self._fingerprint_cache = cached
        return cached

    # ---------------- node-order plumbing ----------------

    def renumber_features(self, feat: np.ndarray) -> np.ndarray:
        """Original-order node array -> the plan's (renumbered) order."""
        if self.perm is None:
            return feat
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(len(self.perm))
        return feat[inv]

    def restore_order(self, out):
        """Map kernel output (new numbering) back to the original node order."""
        if self.perm is None:
            return out
        return out[self.perm]

    # ---------------- device schedules + executors ----------------

    def sched(self, device="cpu"):
        """Cached device-resident forward `DeviceSchedule` on ``device``."""
        import torch

        from repro_torch.kernels.ops import DeviceSchedule
        device = torch.device(device)
        cache = self.__dict__.setdefault("_sched_cache", {})
        hit = cache.get(device)
        if hit is None or hit[0] is not self.partition:
            hit = cache[device] = (self.partition,
                                   DeviceSchedule(self.partition, device))
        return hit[1]

    def executor(self, backend: str = "cuda", device="cuda"):
        """Single-device `PlanExecutor` bound to this plan."""
        from repro_torch.core.aggregate import PlanExecutor
        return PlanExecutor(self, backend=backend, device=device)

    # ---------------- serialization ----------------

    def save(self, path: str) -> None:
        """Serialize to ``path`` (npz, the reference's schema version 2).
        The tuner trace and extracted props are not persisted."""
        data: dict = {
            "version": np.asarray(2),
            "epoch": np.asarray(int(self.epoch)),
            "graph_indptr": self.graph.indptr,
            "graph_indices": self.graph.indices,
            "stats_json": np.frombuffer(
                json.dumps(self.stats).encode(), dtype=np.uint8),
            "reduce_dim_first": np.asarray(int(self.reduce_dim_first)),
        }
        for k in ("gs", "gpt", "dt", "src_win", "ont"):
            data[f"cfg_{k}"] = np.asarray(getattr(self.config, k))
        data["cfg_variant"] = np.frombuffer(
            self.config.variant.encode(), dtype=np.uint8)
        data["cfg_feat_dtype"] = np.frombuffer(
            self.config.feat_dtype.encode(), dtype=np.uint8)
        if self.perm is not None:
            data["perm"] = self.perm
        if self.arch is not None:
            data["arch_json"] = np.frombuffer(
                json.dumps(dataclasses.asdict(self.arch)).encode(),
                dtype=np.uint8)
        for prefix, part in (("p", self.partition), ("b", self.partition_bwd)):
            if part is None:
                continue
            for f in _PARTITION_ARRAYS:
                data[f"{prefix}_{f}"] = getattr(part, f)
            for f in _PARTITION_STATICS:
                data[f"{prefix}_{f}"] = np.asarray(getattr(part, f))
        if self.edge_perm_bwd is not None:
            data["edge_perm_bwd"] = self.edge_perm_bwd
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str) -> "Plan":
        """Inverse of `save` (tuner/props come back as None).  Versionless
        legacy archives load as schema v1 (epoch 0); newer archives refuse
        to load rather than misread fields."""
        z = np.load(path)
        version = int(z["version"]) if "version" in z else 1
        if version > 2:
            raise ValueError(f"plan npz schema version {version} is newer "
                             f"than this runtime (max 2)")

        def part(prefix):
            if f"{prefix}_nbrs" not in z:
                return None
            return GroupPartition(
                **{f: z[f"{prefix}_{f}"] for f in _PARTITION_ARRAYS},
                **{f: int(z[f"{prefix}_{f}"]) for f in _PARTITION_STATICS})

        arch = None
        if "arch_json" in z:
            arch = GNNArchProps(**json.loads(bytes(z["arch_json"]).decode()))
        return cls(
            graph=CSRGraph(z["graph_indptr"], z["graph_indices"]),
            partition=part("p"),
            config=AggConfig(
                gs=int(z["cfg_gs"]), gpt=int(z["cfg_gpt"]),
                dt=int(z["cfg_dt"]), src_win=int(z["cfg_src_win"]),
                ont=int(z["cfg_ont"]),
                variant=bytes(z["cfg_variant"]).decode(),
                feat_dtype=(bytes(z["cfg_feat_dtype"]).decode()
                            if "cfg_feat_dtype" in z else "float32")),
            graph_props=None, arch=arch,
            perm=z["perm"] if "perm" in z else None,
            tuner=None,
            stats=json.loads(bytes(z["stats_json"]).decode()),
            reduce_dim_first=bool(int(z["reduce_dim_first"])),
            partition_bwd=part("b"),
            edge_perm_bwd=(z["edge_perm_bwd"] if "edge_perm_bwd" in z
                           else None),
            epoch=int(z["epoch"]) if "epoch" in z else 0,
        )
