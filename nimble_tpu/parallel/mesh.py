"""Device mesh planning and sharding for multi-chip alignment.

The reference is a single-host batch tool (threads only; SURVEY §2.8); this
module is the scale-out layer it lacks. Parallelism axes:

  "data"    — read-batch parallelism (the dominant axis: pseudoalignment is
              embarrassingly parallel over reads).
  "feature" — equivalence-class bitset words sharded across chips: every
              device holds the full (replicated) k-mer hash table — the probe
              is gather-heavy and cheap to replicate — but only a slice of
              the (n_classes, W) class-bitset matrix. The AND-intersection is
              elementwise over W, so the hot loop needs NO collectives; XLA
              inserts the small all-reduces for `any(bits != 0)` style
              reductions automatically. This is the tensor-parallel analog
              for libraries whose color table exceeds one chip's HBM
              (e.g. the ~20k-allele HLA/KIR library).

Grouping/count reduction across hosts (the data-parallel all-to-all on
cell-barcode buckets) lives in nimble_tpu.parallel.dist.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclass
class MeshPlan:
    mesh: Mesh

    @property
    def n_data(self) -> int:
        return self.mesh.shape["data"]

    @property
    def n_feature(self) -> int:
        return self.mesh.shape["feature"]

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    @property
    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def data_sharded(self) -> NamedSharding:
        return self.sharding("data")

    @property
    def batch_sharded(self) -> NamedSharding:
        return self.sharding("data", None)

    @property
    def bits_sharded(self) -> NamedSharding:
        return self.sharding("data", "feature")


def make_mesh(
    n_data: Optional[int] = None,
    n_feature: int = 1,
    devices=None,
) -> MeshPlan:
    """Build a ("data", "feature") mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_feature
    assert n_data * n_feature <= len(devices), (
        f"mesh {n_data}x{n_feature} needs more than {len(devices)} devices"
    )
    dev_array = np.array(devices[: n_data * n_feature]).reshape(n_data, n_feature)
    return MeshPlan(Mesh(dev_array, ("data", "feature")))


def parse_mesh_spec(spec: str, devices=None) -> Optional[MeshPlan]:
    """Parse the CLI mesh spec into a MeshPlan.

    Accepted forms: "data=4,feature=2", "data=8", "feature=2" (data fills
    the remaining devices), a bare int "8" (all data), or "auto" (all
    available devices on the data axis). Empty/None -> None (single-device,
    no mesh).
    """
    if not spec:
        return None
    spec = spec.strip().lower()
    devices = devices if devices is not None else jax.devices()
    if spec == "auto":
        return make_mesh(n_data=len(devices), devices=devices)
    if spec.isdigit():
        return make_mesh(n_data=int(spec), devices=devices)
    n_data = None
    n_feature = 1
    for part in spec.split(","):
        if not part:
            continue
        try:
            axis, _, value = part.partition("=")
            value = int(value)
        except ValueError:
            raise ValueError(f"bad mesh spec entry {part!r} (want axis=N)")
        if axis == "data":
            n_data = value
        elif axis == "feature":
            n_feature = value
        else:
            raise ValueError(f"unknown mesh axis {axis!r} (want data/feature)")
    return make_mesh(n_data=n_data, n_feature=n_feature, devices=devices)


def pad_axis(arr: np.ndarray, axis: int, multiple: int, fill=0) -> np.ndarray:
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    return np.pad(arr, pad, constant_values=fill)


def plan_index_placement(index, hbm_bytes_per_chip: Optional[int] = None, n_chips: int = 1):
    """Replicate-vs-shard planner for an index against the per-chip device
    memory budget (SURVEY §5.7: prefer replicating the index and sharding
    the read stream — embarrassingly parallel, no inner-loop comm — and
    shard the class-bitset matrix over the feature axis only when it must
    spill). hbm_bytes_per_chip defaults to the first device's own
    allocator limit (accel.device_bytes_limit; an error on a device that
    reports none, such as the CPU, where callers pass a size).

    Returns a dict: {"table_bytes", "class_bytes", "replicate_table",
    "feature_shards"}: feature_shards == 1 means fully replicated.
    """
    table_bytes = int(
        index.table_hi.nbytes
        + index.table_lo.nbytes
        + index.table_vsame.nbytes
        + index.table_vdiff.nbytes
    )
    class_bytes = int(index.class_bits.nbytes)
    if hbm_bytes_per_chip is None:
        from nimble_tpu import accel

        hbm_bytes_per_chip = accel.device_bytes_limit()
    budget = int(hbm_bytes_per_chip * 0.6)  # leave room for batches/workspace

    feature_shards = 1
    while table_bytes + class_bytes // feature_shards > budget:
        feature_shards *= 2
        if feature_shards > max(1, n_chips):
            break
    fits = table_bytes + class_bytes // feature_shards <= budget
    return {
        "table_bytes": table_bytes,
        "class_bytes": class_bytes,
        "replicate_table": True,
        "feature_shards": min(feature_shards, max(1, n_chips)),
        "fits": fits,
    }


def shard_tables(tables: dict, plan: MeshPlan) -> dict:
    """Place index tensors on the mesh: hash table + stash replicated,
    class bitsets sharded over the feature axis (word dim padded to the
    shard count)."""
    out = {}
    for key, arr in tables.items():
        if key == "class_bits":
            arr = jax.device_put(
                pad_axis(np.asarray(arr), 1, plan.n_feature),
                plan.sharding(None, "feature"),
            )
        else:
            arr = jax.device_put(np.asarray(arr), plan.replicated)
        out[key] = arr
    return out
