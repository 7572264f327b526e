"""Training and synthesis over several ranks: one process per card.

Counterpart of ``ste_gan_tpu/parallel/``:

* ``mesh.py``: the process group, batch slicing, the coalesced gradient
  all-reduce and the collectives that carry a gradient;
* ``fsdp.py``: the GAN train state stored sharded over the (data) ranks;
* ``tensor_parallel.py``: the ``(data, model)`` layout of the ranks, the
  partition rule, output-channel slabs of both networks and of the
  encoder, and the collectives of the partitioning;
* ``sequence_parallel.py``: generator synthesis with the time axis split
  over the ranks (halo exchange);
* ``pipeline_parallel.py``: the ``(data, stage)`` layout and the GPipe
  schedule of the encoder's transformer stack, forward and backward, over
  point-to-point messages;
* ``expert_parallel.py``: the ``(data, expert)`` layout and the experts of
  the mixture-of-experts blocks split over it;
* ``multiprocess.py``: the worker one rank of a fleet runs;
* ``multiprocess_axes.py``: the worker of the pipeline and expert axes
  across processes;
* ``launch.py``: the supervisor that runs, watches and recovers a fleet.
"""
import importlib

#: The package's names and the module of each, imported on first use
#: (``ops/conv.py`` imports ``tensor_parallel``, so an eager import here
#: would run in a cycle).
_EXPORTS = {
    "synthesize_time_sharded": "sequence_parallel",
    **{name: "pipeline_parallel" for name in (
        "STAGE_AXIS", "StageMesh", "create_stage_mesh",
        "create_stage_mesh_2d", "pipeline_apply", "stage_layers")},
    **{name: "expert_parallel" for name in (
        "EXPERT_AXIS", "create_expert_mesh", "is_expert_param",
        "shard_moe_module_")},
    **{name: "tensor_parallel" for name in (
        "Mesh2D", "copy_to_model", "create_mesh_2d", "gather_from_model",
        "leaf_partition_spec", "replicated_sum", "shard_batch_2d",
        "shard_state", "shard_module_", "sharding_summary",
        "state_shardings", "unshard_state")},
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
