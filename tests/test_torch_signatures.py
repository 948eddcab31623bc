"""The port's public signatures against the JAX package's.

For every module of `megapose6d_tpu` and its counterpart of the same path
in `megapose6d_tpu_torch`, and for every public function, class, method
and dataclass that the JAX module defines:

1. every parameter of the JAX one is a parameter of the port's, under the
   same name;
2. the JAX one's positional parameters are the port's first positional
   parameters, in the same order, so a positional call written against the
   JAX package binds the same way on the port (the port's own additions
   come after them or are keyword-only);
3. where the JAX default is a literal (a number, string, bool, None, or a
   tuple or list of them), the port's default is equal (a tuple equals a
   list of the same items);
4. every public method and property of a JAX class is on the port's class;
5. every field of a JAX dataclass is a field of the port's, with an equal
   literal default. A flax module is a dataclass whose fields are its
   constructor's parameters; its counterpart is a torch module, so its
   fields are held as the port's constructor parameters by rules 1-3.
   What flax's `Module` itself defines (`parent`, `name`, `scope`, `apply`,
   `init`, ...) is flax's machinery, not the class's;
6. every public module-level name of a JAX module (functions, classes,
   constants) is in the port's module of the same path.

The only way out is `JAX_ONLY`, keyed by the JAX name (`module.name`; a
name a package re-exports under the module defining it) or by the JAX
name and its
parameter (`module.name:param`, `module.Class:field` for a constructor's
parameter or a field, `module.Class.method:param`), each with what the
port does instead. A reason is admitted only where the name or parameter
carries a JAX object that means nothing in PyTorch: a PRNG key, flax
params, Pallas `interpret`, a `jax.sharding` mesh or axis, a flax-only
method, a jit factory. `tests/test_torch_package_names.py` reads its
package-level exceptions from the same list.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import importlib
import inspect
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# What the port does instead of each JAX-only name or parameter.
JAX_ONLY = {
    # Package-level names (`megapose6d_tpu/<sub>/__init__.py`); a name a
    # package re-exports is listed under the module that defines it.
    "training.train": "the JAX `__init__.py` binds its loop over its submodule `training.train`; the "
                      "port's `training.train` stays the module (its loop `training.train.train`), "
                      "which the port's scripts import as `from ..training import train as tt`",
    "training.forward_loss": "the JAX `__init__.py` binds the function over its submodule "
                             "`training.forward_loss`; the port's stays the module (the function "
                             "`training.forward_loss.forward_loss`), which its tests import as a module",
    # Module-level names.
    "data.tensor_collection.PandasTensorCollection": "a pandas DataFrame beside JAX arrays; the port's is "
                                                     "`TensorCollection`, with no pandas on the card's machine",
    "parallel.mesh.replicated": "a JAX NamedSharding; the port's devices are a list of torch devices and "
                                "a replicated tensor is a copy on each",
    "interop.torch_convert.pose_predictor_params_from_torch": "reference weights into flax params; the port "
                                                              "loads them with "
                                                              "`pose_predictor_state_dict_from_reference`",
    "utils.compile_cache": "XLA's persistent compilation cache; the port compiles its kernels with nvcc "
                           "into `build/` (`ops/_nvcc.py`)",
    "ops._precision.einsum": "a `jnp.einsum` pinned to `Precision.HIGHEST`; the port turns TF32 off "
                             "process-wide (`ops._precision.pin_f32`) and uses torch's einsum",
    "ops._precision.matmul": "a `jnp.matmul` pinned to `Precision.HIGHEST`; as `ops._precision.einsum`",
    "ops.rasterizer_tiled.force_interpret": "Pallas interpret mode; the port's kernel has a plain torch "
                                            "twin it takes for CPU tensors",
    "models.pose_predictor.skip_render_for_init": "a flax-only switch that skips the render while "
                                                  "`model.init` traces shapes; a torch module is built "
                                                  "without a forward pass",
    "models.pose_predictor.PosePredictor.setup": "flax's module construction hook; the port's is "
                                                 "`PosePredictor.__init__`",
    "training.train.make_train_step": "a jit factory of a jax train step; the port's step is "
                                      "`training.train.train_step`, eager PyTorch",
    "training.train.make_sharded_train_step": "a jit factory of the label-sharded jax step; the port's is "
                                              "`train_step` on a rank's shard (`reduce_over=`)",
    # Parameters and fields.
    "models.backbones.make_backbone:in_channels": "a torch module needs its input shape when it is built, "
                                                  "where flax infers it; it comes ahead of `n_features`",
    "models.backbones.make_backbone:input_hw": "as `make_backbone:in_channels`",
    "models.backbones.ZooBasicBlockV2:bn_axis_name": "a jax mesh axis for cross-replica BatchNorm; the "
                                                     "port's is a process group (`synced_batch_stats`)",
    "models.backbones.ZooWideResNet:bn_axis_name": "as `ZooBasicBlockV2:bn_axis_name`",
    "models.detector.Detector:params": "flax params; a torch module holds its own weights",
    "inference.pose_estimator.PoseEstimator:coarse_params": "flax params; a torch module holds its own "
                                                            "weights",
    "inference.pose_estimator.PoseEstimator:refiner_params": "flax params; as `coarse_params`",
    "scripts.run_detector_training.evaluate_detector:params": "flax params; a torch module holds its own "
                                                              "weights",
    "training.visualization.make_debug_visualization:params": "flax params; a torch module holds its own "
                                                              "weights",
    "training.forward_loss.forward_loss:params": "flax params; a torch module holds its own weights",
    "training.forward_loss.forward_loss:key": "a PRNG key; the port takes the step's draws "
                                              "(`draw_forward_loss`, from a torch.Generator)",
    "training.forward_loss.make_hypotheses:key": "a PRNG key; the port takes the draws "
                                                 "(`draw_forward_loss(...)['hyp']`)",
    "training.train.create_train_state:key": "a PRNG key; the port draws the weights from a torch.Generator "
                                             "seeded with `cfg.seed`",
    "training.train.train:device_mesh": "a jax.sharding Mesh that shards each batch over devices in one "
                                        "process; the port runs a process a device, `reduce_over=`",
    "training.train.TrainState:apply_fn": "the flax module's `apply`; the port's `TrainState.model` is the "
                                          "torch module",
    "training.train.TrainState:params": "flax params; the port's are the model's (`TrainState.params`)",
    "training.train.TrainState:tx": "an optax transformation; the port's is `TrainState.optimizer` "
                                    "(`make_optimizer`)",
    "ops.se3.random_rotations:key": "a PRNG key; the port takes the normals (`normals=`) or a "
                                    "torch.Generator (`generator=`)",
    "ops.se3.small_random_rotations:key": "a PRNG key; the port takes the draws (`axis_normals=`, "
                                          "`uniforms=`) or a torch.Generator",
    "ops.se3.add_pose_noise:key": "a PRNG key; the port takes the normals (`euler_normals=`, "
                                  "`trans_normals=`) or a torch.Generator",
    "ops.rasterizer_tiled.render_meshes_tiled:interpret": "Pallas interpret mode; the port takes its "
                                                          "kernel's plain twin for CPU tensors",
    "meshes.sharded_db.ShardedMeshDB:batched": "a BatchedMeshes whose arrays a jax.sharding mesh shards "
                                               "over devices; the port keeps one per device (`shards`)",
    "meshes.sharded_db.ShardedMeshDB.build:axis": "a jax.sharding mesh axis; the port's `device_mesh` is "
                                                  "a list of devices",
    "parallel.mesh.make_mesh:axis": "a jax.sharding mesh axis; the port's mesh is a list of devices",
    "parallel.mesh.batch_sharding:mesh": "a jax.sharding Mesh; the port's `batch_sharding` gives each of "
                                         "`n_shards` its rows",
    "parallel.mesh.batch_sharding:axis": "a jax.sharding mesh axis; as `batch_sharding:mesh`",
    "parallel.mesh.shard_batch:axis": "a jax.sharding mesh axis; the port's mesh is a list of devices",
}

# Result-changing options that no reason admits.
NEVER_JAX_ONLY = {
    "z_range", "shadows", "ibl", "one_instance_per_class", "detection_th", "batch_im_ids",
    "apply_rgb_augmentation", "runs", "rescaled", "mesh_units", "label_to_obj_id", "shard_format",
    "prefetch", "size", "cells", "max_children", "mask", "masks", "valid", "orig_size", "ypr_offset_deg",
    # train's and create_train_state's
    "batch_iterator", "run_dir", "n_epochs", "steps_per_epoch", "input_res", "val_iterator",
    "n_val_batches", "model", "mesh_db", "cfg", "log_fn",
}

LITERALS = (bool, int, float, str, type(None))


def jax_modules() -> list[str]:
    """Every module of the JAX package, as a dotted path under it
    (`""` for the package, `"ops"` for `ops/__init__.py`)."""
    out = []
    for path in sorted((ROOT / "megapose6d_tpu").rglob("*.py")):
        parts = list(path.relative_to(ROOT / "megapose6d_tpu").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = jax_modules()
PORTED = [m for m in MODULES if m not in JAX_ONLY
          or (ROOT / "megapose6d_tpu_torch" / Path(*m.split("."))).with_suffix(".py").exists()]


def qual(module: str, name: str) -> str:
    return f"{module}.{name}" if module else name


def jax_only_reason(module: str, name: str) -> str | None:
    """The `JAX_ONLY` reason of `name` in `module`: its own entry, or, for
    a name a package re-exports, the entry under the module defining it."""
    key = qual(module, name)
    if key in JAX_ONLY:
        return JAX_ONLY[key]
    pattern = rf"{re.escape(module)}\.\w+\.{re.escape(name)}" if module else None
    return next((r for k, r in JAX_ONLY.items() if pattern and re.fullmatch(pattern, k)), None)


def load(module: str):
    jax_mod = importlib.import_module("megapose6d_tpu" + (f".{module}" if module else ""))
    port_mod = importlib.import_module("megapose6d_tpu_torch" + (f".{module}" if module else ""))
    return jax_mod, port_mod


def defined_names(module: str) -> list[str]:
    """The public names a JAX module binds itself: its defs, classes and
    assignments at top level (in `if` / `try` blocks too), and for a
    package the names its `from .x import` lines bind."""
    rel = Path(*module.split(".")) if module else Path()
    path = ROOT / "megapose6d_tpu" / rel
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names: list[str] = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.append(node.name)
            elif isinstance(node, ast.Assign):
                names.extend(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.append(node.target.id)
            elif isinstance(node, ast.ImportFrom) and node.level == 1 and path.name == "__init__.py":
                names.extend(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for handler in node.handlers:
                    visit(handler.body)
                visit(node.orelse)

    visit(ast.parse(path.read_text()).body)
    return list(dict.fromkeys(n for n in names if not n.startswith("_")))


def is_jax_type(obj) -> bool:
    """A module-level alias of a JAX type (`Array = jax.Array`); the
    port's modules alias torch's (`Tensor = torch.Tensor`)."""
    return inspect.isclass(obj) and (obj.__module__ or "").split(".")[0] in ("jax", "jaxlib", "flax", "optax")


def literal(value) -> bool:
    if isinstance(value, (tuple, list)):
        return all(literal(v) for v in value)
    return isinstance(value, LITERALS)


def same_literal(a, b) -> bool:
    """Equal literals: a tuple equals a list of the same items; a bool
    only a bool."""
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(map(same_literal, a, b))
    return isinstance(b, LITERALS) and isinstance(a, bool) == isinstance(b, bool) and a == b


def flax_base_names() -> set[str]:
    import flax.linen as nn

    return {n for n in dir(nn.Module) if not n.startswith("_")} | {"parent", "name", "scope"}


def is_flax_module(cls) -> bool:
    import flax.linen as nn

    return inspect.isclass(cls) and issubclass(cls, nn.Module)


POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def signature_gaps(key: str, jax_fn, port_fn, skip: set[str] = frozenset()) -> list[str]:
    """Rules 1-3 for one callable; `key` is its JAX_ONLY key."""
    try:
        js = inspect.signature(jax_fn)
    except (TypeError, ValueError):
        return []
    try:
        ps = inspect.signature(port_fn)
    except (TypeError, ValueError):
        return [f"{key}: the port's has no signature"]
    listed = {p for k in JAX_ONLY if k.startswith(key + ":") for p in [k.split(":", 1)[1]]}
    jp = {n: p for n, p in js.parameters.items() if n not in skip
          and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    pp = ps.parameters
    gaps = []
    for n in jp:
        if n in listed:
            continue
        if n not in pp:
            gaps.append(f"{key}: lacks parameter {n!r}")
            continue
        d = jp[n].default
        if d is not inspect.Parameter.empty and literal(d) and not same_literal(d, pp[n].default):
            gaps.append(f"{key}: default of {n!r} is {pp[n].default!r}, the JAX one's {d!r}")
    jpos = [n for n, p in jp.items() if p.kind in POSITIONAL and n not in listed]
    ppos = [n for n, p in pp.items() if p.kind in POSITIONAL and n not in listed]
    if ppos[:len(jpos)] != jpos:
        gaps.append(f"{key}: positional order {ppos}, the JAX one's {jpos}")
    return gaps


def dataclass_fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else {}


def class_gaps(key: str, jax_cls, port_cls) -> list[str]:
    """Rules 1-5 for one class."""
    flax = is_flax_module(jax_cls)
    base = flax_base_names() if flax else set()
    jfields = {n: f for n, f in dataclass_fields(jax_cls).items() if n not in base}
    gaps = []
    if jfields and not flax:
        if not dataclasses.is_dataclass(port_cls):
            return [f"{key}: the JAX one is a dataclass, the port's is not"]
        pfields = dataclass_fields(port_cls)
        for n, f in jfields.items():
            if f"{key}:{n}" in JAX_ONLY:
                continue
            if n not in pfields:
                gaps.append(f"{key}: lacks field {n!r}")
            elif f.default is not dataclasses.MISSING and literal(f.default) and not same_literal(
                    f.default, pfields[n].default):
                gaps.append(f"{key}: default of field {n!r} is {pfields[n].default!r}, the JAX one's {f.default!r}")
    if not issubclass(jax_cls, enum.Enum):
        gaps += signature_gaps(key, jax_cls, port_cls, skip=base)
    for name, value in vars(jax_cls).items():
        if name.startswith("_") or name in jfields or name in base or f"{key}.{name}" in JAX_ONLY:
            continue
        if not hasattr(port_cls, name):
            gaps.append(f"{key}: lacks {name!r}")
            continue
        if isinstance(value, (staticmethod, classmethod)) or inspect.isfunction(value):
            gaps += signature_gaps(f"{key}.{name}", getattr(jax_cls, name), getattr(port_cls, name))
    return gaps


@pytest.mark.parametrize("module", PORTED)
def test_module_names(module):
    """Rule 6: every public module-level name of the JAX module is in the
    port's module of the same path."""
    jax_mod, port_mod = load(module)
    missing = [n for n in defined_names(module) if jax_only_reason(module, n) is None
               and not is_jax_type(getattr(jax_mod, n, None)) and not hasattr(port_mod, n)]
    assert missing == [], f"megapose6d_tpu_torch.{module} lacks {missing}"


@pytest.mark.parametrize("module", PORTED)
def test_function_signatures(module):
    """Rules 1-3 for the module's public functions."""
    jax_mod, port_mod = load(module)
    gaps = []
    for name in defined_names(module):
        key = qual(module, name)
        jax_obj = getattr(jax_mod, name, None)
        if key in JAX_ONLY or inspect.isclass(jax_obj) or not callable(jax_obj) or is_jax_type(jax_obj):
            continue
        if (getattr(inspect.unwrap(jax_obj), "__module__", "") or "") != jax_mod.__name__ and module:
            continue  # a package re-exports it; its own module's case holds it
        gaps += signature_gaps(key, jax_obj, getattr(port_mod, name, None))
    assert gaps == [], "\n".join(gaps)


@pytest.mark.parametrize("module", PORTED)
def test_class_signatures(module):
    """Rules 1-5 for the module's public classes."""
    jax_mod, port_mod = load(module)
    gaps = []
    for name in defined_names(module):
        key = qual(module, name)
        jax_obj = getattr(jax_mod, name, None)
        if key in JAX_ONLY or not inspect.isclass(jax_obj) or jax_obj.__module__ != jax_mod.__name__:
            continue
        gaps += class_gaps(key, jax_obj, getattr(port_mod, name))
    assert gaps == [], "\n".join(gaps)


def test_jax_only_list_names_jax_objects():
    """Rule 7: every entry names a JAX module, name or parameter that
    exists, lists no result-changing option, and gives a reason."""
    for key, reason in JAX_ONLY.items():
        assert isinstance(reason, str) and len(reason) > 10, key
        name, _, param = key.partition(":")
        assert param not in NEVER_JAX_ONLY, f"{key}: a result-changing option cannot be JAX-only"
        if name in MODULES and not param:
            continue
        module = max((m for m in MODULES if name.startswith(m + ".") or not m), key=len)
        obj = importlib.import_module("megapose6d_tpu" + (f".{module}" if module else ""))
        for part in name[len(module):].lstrip(".").split("."):
            assert hasattr(obj, part), f"{key}: no such JAX name"
            obj = getattr(obj, part)
        if param:
            params = set(inspect.signature(obj).parameters) | set(dataclass_fields(obj) if inspect.isclass(obj) else ())
            port = importlib.import_module("megapose6d_tpu_torch" + (f".{module}" if module else ""))
            for part in name[len(module):].lstrip(".").split("."):
                port = getattr(port, part, None)
            port_params = set(inspect.signature(port).parameters) if port is not None else set()
            assert param in params or param in port_params, f"{key}: no such parameter"
