"""The distributed layer on ``torch.distributed``: data parallelism of the
occupancy and proposal trainers (``mesh``), tensor parallelism of the CP
field on a (data, model) mesh (``tp``), a launcher of ranks on one machine
(``launch``) and the dry run (``dryrun``).  PyTorch counterpart of
nerfacc_tpu/parallel."""
from .launch import spawn
from .mesh import make_dp_prop_step, make_dp_train_step, make_mesh, shard_batch
from .tp import (
    gather_state,
    make_mesh_2d,
    make_tp_field,
    make_tp_train_step,
    permute_w1,
    shard_state,
    tp_w1_permutation,
)

__all__ = [
    "make_mesh",
    "make_dp_train_step",
    "make_dp_prop_step",
    "shard_batch",
    "make_mesh_2d",
    "make_tp_field",
    "make_tp_train_step",
    "permute_w1",
    "tp_w1_permutation",
    "spawn",
    "gather_state",
    "shard_state",
    "dryrun_multichip",
]


def __getattr__(name):
    # the dry run imports the trainers and fields, which import this
    # package's modules: bind it on first use
    if name == "dryrun_multichip":
        from .dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
