"""The port's package-level names: for each subpackage, every public name
that the JAX package's `__init__.py` binds (its `from .module import ...`
names and the functions it defines) imports from the port's subpackage of
the same name, except the JAX-only names that `tests/test_torch_signatures.py`
lists with their reasons (`JAX_ONLY`, the one list of both tests); no
package-level name hides a submodule of the same name. Then
`meshes.make_axes` and `native.supports` against the JAX package's."""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_signatures import jax_only_reason

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["meshes", "training", "evaluation", "models", "data", "utils", "parallel", "visualization",
               "interop", "native", "inference"]


def jax_public_names(sub: str) -> list[str]:
    """The names `megapose6d_tpu/<sub>/__init__.py` binds by `from .x
    import` and by its own definitions, less those starting with `_`."""
    tree = ast.parse((ROOT / "megapose6d_tpu" / sub / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return [n for n in names if not n.startswith("_")]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_no_exported_name_hides_a_submodule(sub):
    """A package-level name that is also a submodule's name would make
    `from megapose6d_tpu_torch.<sub> import <module>` give the name, not
    the module the port's scripts and tests import."""
    import pkgutil
    import types

    port = importlib.import_module(f"megapose6d_tpu_torch.{sub}")
    for module in pkgutil.iter_modules(port.__path__):
        importlib.import_module(f"megapose6d_tpu_torch.{sub}.{module.name}")
        assert isinstance(getattr(port, module.name), types.ModuleType), f"megapose6d_tpu_torch.{sub}.{module.name}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_public_name_of_the_jax_package(sub):
    names = jax_public_names(sub)
    assert names, sub
    only = {n: r for n in names if (r := jax_only_reason(sub, n)) is not None}
    port = importlib.import_module(f"megapose6d_tpu_torch.{sub}")
    missing = [n for n in names if n not in only and not hasattr(port, n)]
    assert missing == [], f"megapose6d_tpu_torch.{sub} lacks {missing}"
    exec(f"from megapose6d_tpu_torch.{sub} import {', '.join(n for n in names if n not in only)}", {})
    for name in only:
        assert not callable(getattr(port, name, None)), f"{sub}.{name} is listed JAX-only but the port has it"


def test_the_jax_only_list_names_the_port_counterparts():
    import types

    from megapose6d_tpu_torch import training
    from megapose6d_tpu_torch.data import TensorCollection  # noqa: F401
    from megapose6d_tpu_torch.interop.torch_convert import pose_predictor_state_dict_from_reference  # noqa: F401
    from megapose6d_tpu_torch.training.forward_loss import forward_loss
    from megapose6d_tpu_torch.training.train import train, train_step  # noqa: F401

    assert isinstance(training.train, types.ModuleType) and training.train.train is train
    assert isinstance(training.forward_loss, types.ModuleType) and training.forward_loss.forward_loss is forward_loss


@pytest.mark.parametrize("length,radius_ratio", [(0.1, 0.03), (0.25, 0.05)])
def test_make_axes(length, radius_ratio):
    from megapose6d_tpu.meshes import make_axes as jax_make_axes
    from megapose6d_tpu_torch.meshes import make_axes

    got, want = make_axes(length, radius_ratio), jax_make_axes(length, radius_ratio)
    assert got.faces.dtype == np.int32 and np.array_equal(got.faces, want.faces)
    for attr in ("vertices", "vertex_colors", "vertex_normals"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert a.shape == b.shape and a.dtype == np.float32, attr
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=attr)
    assert got.vertices.max(0).min() > 0.9 * length  # each axis reaches its length


def test_native_supports():
    from megapose6d_tpu import native as jax_native
    from megapose6d_tpu_torch import native

    heads = [b"\x89PNG\r\n\x1a\n" + bytes(8), b"\xff\xd8\xff\xe0" + bytes(8), b"\xff\xd8\xff\xdb", b"II*\x00" + bytes(8),
             b"MM\x00*" + bytes(8), b"GIF89a", b"", b"\x89PN", b"\xff\xd8", b"junk" * 4, bytes(16)]
    for path in sorted((ROOT / "tests/data/torch_images").rglob("*"))[:40]:
        if path.is_file():
            heads.append(path.read_bytes()[:16])
    for head in heads:
        assert native.supports(head) == jax_native.supports(head), head
    assert native.supports(heads[0]) and native.supports(heads[1]) and not native.supports(heads[3])
