"""Elastic scaling: rebuild the mesh from surviving ranks and re-shard.

The port of ``src/repro/distributed/elastic.py``. Checkpoints are
topology-independent (whole host arrays keyed by tree path), so
elasticity is: (1) choose a new mesh shape from the available rank
count, (2) re-derive the specs (they are symbolic, not bound to a device
count), (3) distribute the restored state under the new placements,
(4) re-partition the data stream (the pipeline's sharding is a pure
function of (step, shard, n_shards)).

``choose_mesh_shape`` keeps the model axis at the largest power of two
up to ``prefer_model`` that divides the rank count, dropping
data-parallel width first, which changes only throughput, never
legality.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import partition


def choose_mesh_shape(n_devices: int, *, prefer_model: int = 16,
                      max_model_divisor: int = 16) -> tuple[int, int]:
    """(data, model) for an arbitrary surviving device count."""
    model = min(prefer_model, max_model_divisor)
    while model > 1 and n_devices % model != 0:
        model //= 2
    return n_devices // model, model


def rebuild_mesh(n_or_ranks=None, *, prefer_model: int = 16) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the first ``data * model`` of
    ``n_or_ranks`` (a rank count, counted from rank 0, or a list of
    ranks; default every rank of the default group), on ``"cuda"`` under
    NCCL and ``"cpu"`` otherwise. Every rank of the default group must
    call it (building the mesh's groups is a collective); a rank outside
    the mesh gets it without a coordinate."""
    if n_or_ranks is None:
        n_or_ranks = dist.get_world_size()
    ranks = (list(range(n_or_ranks)) if isinstance(n_or_ranks, int)
             else list(n_or_ranks))
    data, model = choose_mesh_shape(len(ranks), prefer_model=prefer_model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks[: data * model]).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def reshard_state(state, mesh):
    """Re-shard a (restored, host-resident) state tree onto ``mesh``
    using the standard partitioning rules, with divisibility fixes for
    the new axis sizes."""
    params = state["params"] if isinstance(state, dict) and "params" in state else state
    specs = partition.param_specs(params)
    specs = partition.validate_divisibility(specs, params, mesh)
    new_params = partition.distribute(params, specs, mesh)
    if isinstance(state, dict) and "params" in state:
        out = dict(state)
        out["params"] = new_params
        return out
    return new_params
