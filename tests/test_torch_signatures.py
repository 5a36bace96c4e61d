"""The port takes the JAX package's public parameters.

For every public function and class of every module of ``nerfacc_tpu``
(its constructor, and each public method, ``__call__`` held to the port's
``forward``), the counterpart of the same name in the same module of
``nerfacc_tpu_torch`` must take every parameter name the JAX one takes, by
``inspect.signature``, or the name must be on :data:`ALLOWED` with the
reason the port keeps it out.  JAX's ``*args`` / ``**kwargs`` pass names on
and are not counted; where the port's constructor takes ``**kwargs``, the
constructors of its bases count as its own.  Imports both packages and
compiles nothing.
"""
import importlib
import inspect
import pkgutil

import pytest

import nerfacc_tpu
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

_LAYOUT = "a TPU layout or compile option; the port's kernels need none"
_PARAMS = "JAX passes the module's parameters in; the port's module holds them"
_AXIS = "a JAX mesh axis name; the port takes a torch.distributed group"
_INTERPRET = "Pallas interpret mode; the port runs a CPU tensor's plain version"

# "module:name" or "module:name:parameter" (module relative to the package)
# -> why the port does not take it
ALLOWED = {
    # modules and names of the TPU's gather / scatter workarounds
    "ops.compaction": "cumsum-inversion compaction; G2 packs exactly",
    "ops.hash_vmem": "the lane-folded hash layout (plan_lanes, fold_table, "
                     "hash_vmem_lookup); G6 reads the table in place",
    "ops.table_grad": "sorted-block table gradients; G7 scatters in place",
    "grid:CoarsePool": "the pooled traversal's coarse summary; no public "
                       "signature of the port takes one",
    "grid:build_coarse_pool": "builds a CoarsePool (see there)",
    "grid:pooled_round_from_coarse": "reads a CoarsePool (see there)",
    "ops.sorted_segments:spread_table": "the exact 3-limb one-hot spread; "
                                        "the port gathers rows",
    "ops.sorted_segments:spread_table_bf16": "the bf16 one-hot spread (see spread_table)",
    # JAX-only idioms
    "data_specs:RaySamples:tree_flatten": "a JAX pytree method",
    "data_specs:RayIntervals:tree_flatten": "a JAX pytree method",
    "estimators.occ_grid:OccGridState:tree_flatten": "a JAX pytree method",
    "estimators.sparse_grid:SparseGrid:tree_flatten": "a JAX pytree method",
    "data.device_sampler:DeviceRaySampler.sample:arrays": (
        "JAX hands its jitted scan the sampler's arrays; the port's sampler holds them"),
    "models.encoders:HashGridEncoder.__call__:table": _PARAMS,
    "models.cp_field:tp_allreduce:axis_name": _AXIS,
    "parallel.mesh:make_mesh:n_devices": (
        "JAX takes the first n local devices; torch.distributed takes world_size and rank"),
    "parallel.mesh:shard_batch:axis_name": _AXIS,
    "parallel.mesh:make_dp_train_step:axis_name": _AXIS,
    "parallel.mesh:make_dp_prop_step:axis_name": _AXIS,
    "parallel.tp:make_mesh_2d:data_axis": _AXIS,
    "parallel.tp:make_mesh_2d:model_axis": _AXIS,
    "parallel.tp:make_tp_field:model_axis": _AXIS,
    "parallel.tp:make_tp_train_step:data_axis": _AXIS,
    "parallel.tp:make_tp_train_step:model_axis": _AXIS,
    "models.cp_field:CPRadianceField:tp_axis": _AXIS,
    "models.cp_field:TensoRFRadianceField:tp_axis": _AXIS,
    "models.cp_field:CPDensityField:tp_axis": _AXIS,
    "ops.coarse_occ:coarse_occ_lookup:interpret": _INTERPRET,
    "ops.cp_level:cp_level_encode:interpret": _INTERPRET,
    "ops.hat_matmul:hat_interp_matmul:interpret": _INTERPRET,
    "ops.lane_gather:lane_gather:interpret": _INTERPRET,
    # PropNetEstimator: its optimiser and schedule are the reference's
    "estimators.prop_net:PropNetEstimator:seed": (
        "the port takes the reference's (optimizer, scheduler); autograd needs no "
        "seeded, retraced closures"),
    "estimators.prop_net:PropNetEstimator:sigma_fns_builder": (
        "JAX rebuilds the density closures per trace; autograd differentiates the "
        "modules the caller passes"),
    # the CP encoder's and NGP's TPU options
    "models.cp_field:CPGridEncoder:kernel": _LAYOUT,
    "models.cp_field:CPGridEncoder:block_size": _LAYOUT,
    "models.cp_field:CPGridEncoder:block_min_res": _LAYOUT,
    "models.cp_field:CPGridEncoder:remat": _LAYOUT,
    "models.cp_field:CPGridEncoder:fused_levels": _LAYOUT,
    "models.cp_field:CPRadianceField:encoder_remat": _LAYOUT,
    "models.cp_field:CPRadianceField:fused_levels": _LAYOUT,
    "models.cp_field:TensoRFRadianceField:encoder_remat": _LAYOUT,
    "models.cp_field:TensoRFRadianceField:fused_levels": _LAYOUT,
    "models.cp_field:CPDensityField:encoder_remat": _LAYOUT,
    "models.encoders:HashGridEncoder:table_grad": _LAYOUT,
    "models.encoders:HashGridEncoder:lookup": _LAYOUT,
    "models.ngp:NGPRadianceField:table_grad": _LAYOUT,
    "models.ngp:NGPRadianceField:hash_lookup": _LAYOUT,
    "models.ngp:NGPDensityField:table_grad": _LAYOUT,
    "models.ngp:NGPDensityField:hash_lookup": _LAYOUT,
}

# parameter names that stand for one idiom wherever they appear
ALLOWED_EVERYWHERE = {
    "self": "the instance",
    "params": _PARAMS,
    "key": "JAX's PRNG key; the port draws from a torch.Generator or takes the draw",
}

MODULES = sorted(
    m.name[len("nerfacc_tpu."):]
    for m in pkgutil.walk_packages(nerfacc_tpu.__path__, "nerfacc_tpu.")
)


def _names(fn, cls=None):
    """The parameter names ``fn`` takes; with ``**kwargs`` on a class's
    constructor, its bases' constructors' too."""
    params = inspect.signature(fn).parameters
    names = {n for n, p in params.items()
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    if cls is not None and any(p.kind == p.VAR_KEYWORD for p in params.values()):
        for base in cls.__mro__[1:]:
            if "__init__" in vars(base):
                names |= _names(base.__init__)
    return names


def _jax_names(fn):
    params = inspect.signature(fn).parameters
    return [n for n, p in params.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _public(module):
    """The module's own public callables."""
    for name, obj in vars(module).items():
        if name.startswith("_") or not callable(obj):
            continue
        if getattr(obj, "__module__", None) == module.__name__:
            yield name, obj


def _pairs(rel, name, jax_obj, port_obj):
    """(key, jax callable, port callable, port class) to compare, and the
    keys of the JAX methods the port lacks."""
    pairs, missing = [(f"{rel}:{name}", jax_obj, port_obj, None)], []
    if inspect.isclass(jax_obj):
        pairs = [(f"{rel}:{name}", jax_obj, port_obj, port_obj)]
        for meth, fn in vars(jax_obj).items():
            if meth.startswith("_") or not inspect.isfunction(fn):
                continue
            port_fn = getattr(port_obj, meth, None)
            if port_fn is None:
                missing.append(f"{rel}:{name}:{meth}")
            else:
                pairs.append((f"{rel}:{name}.{meth}", fn, port_fn, None))
        if inspect.isfunction(vars(jax_obj).get("__call__")):
            port_call = getattr(port_obj, "forward", None) or port_obj.__call__
            pairs.append((f"{rel}:{name}.__call__", jax_obj.__call__, port_call, None))
    return pairs, missing


def _gaps(rel):
    """Every JAX name of module ``rel`` the port does not take: module,
    name, method or parameter keys."""
    jax_mod = importlib.import_module(f"nerfacc_tpu.{rel}")
    try:
        port_mod = importlib.import_module(f"nerfacc_tpu_torch.{rel}")
    except ModuleNotFoundError:
        return [rel]
    gaps = []
    for name, obj in _public(jax_mod):
        port_obj = getattr(port_mod, name, None)
        if port_obj is None:
            gaps.append(f"{rel}:{name}")
            continue
        pairs, missing = _pairs(rel, name, obj, port_obj)
        gaps += missing
        for key, jax_fn, port_fn, port_cls in pairs:
            try:
                want = _jax_names(jax_fn)
                have = _names(port_fn, port_cls)
            except (TypeError, ValueError):  # no signature to read
                continue
            gaps += [f"{key}:{p}" for p in want
                     if p not in have and p not in ALLOWED_EVERYWHERE]
    return gaps


@pytest.mark.parametrize("rel", MODULES)
def test_port_takes_every_jax_parameter(rel):
    """Each JAX module's public names and parameters exist in the port, or
    are allowed with their reason."""
    gaps = [g for g in _gaps(rel) if g not in ALLOWED]
    assert not gaps, f"the port lacks, with no reason given: {gaps}"


def test_every_allowance_is_still_needed():
    """No entry of :data:`ALLOWED` names something the port now takes."""
    found = {g for rel in MODULES for g in _gaps(rel)}
    stale = [k for k in ALLOWED if k not in found]
    assert not stale, f"allowed but taken by the port: {stale}"
