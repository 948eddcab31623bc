"""Port vs JAX: the pieces of the production inference configuration,
on the same seeded numpy inputs.

  - `build_prune_table` for (576, 72), (576, 144) and (16, 4): equal arrays.
  - the bilinear upsample of `render_at` against `jax.image.resize`,
    every row and column (the borders, where the filter is renormalised,
    included): within 1e-6; and a coarse scorer's upsampled renders at
    48x64 from 24x32: at least 99% of the values within 1e-4 and all but
    a silhouette pixel's worth within 0.05 (the packages' geometry differs
    in the last bit, so a pixel on an edge can flip before the upsample
    spreads it).
  - the `wide_resnet18` and `zoo_resnet18` forward passes in f32, with
    the BatchNorm statistics carried across: within 1e-4 relative to the
    outputs' scale.
  - the demo world (textured cube and sphere): equal arrays; its 512-face
    LOD: the same triangles (as sets, see the test); `pose_errors`
    within 1e-6 (1e-4 degree); the threefry draws of the demo: equal, the
    normals within 2 ulp.
  - a twin shares its model's parameter tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.models import pose_predictor as jpp
from megapose6d_tpu.ops import so3_grid as jgrid
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops import cropping
from megapose6d_tpu_torch.ops import so3_grid as tgrid
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.utils import threefry
from tests.torch_production_refs import one_torch_thread  # noqa: F401 (autouse)

pin_f32()


@pytest.mark.parametrize("m,m1", [(576, 72), (576, 144), (16, 4)])
def test_prune_table_matches_jax(m, m1):
    want = jgrid.build_prune_table(jgrid.make_so3_grid(m), jgrid.make_so3_grid(m1))
    got = tgrid.build_prune_table(tgrid.make_so3_grid(m, "cpu"), tgrid.make_so3_grid(m1, "cpu"))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    # The children partition the grid.
    assert sorted(got[0][got[1]].tolist()) == list(range(m))


@pytest.mark.parametrize("hw,size", [((24, 32), (48, 64)), ((120, 160), (240, 320)), ((7, 9), (20, 13))])
def test_resize_bilinear_matches_jax_image_resize(hw, size):
    x = np.random.RandomState(0).uniform(size=(2,) + hw + (7,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + size + (7,), method="bilinear"))
    got = cropping.resize_bilinear(torch.as_tensor(x), size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-6)


def tiny_world():
    from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube
    from megapose6d_tpu_torch.meshes import io as tio
    from megapose6d_tpu_torch.meshes import mesh_db as tdb

    jdb = MeshDataBase.from_object_ds(
        RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04))]),
        max_faces=64, n_points=32, n_sym=2).batched(align=32)
    tdb_ = tdb.MeshDataBase.from_object_ds(
        tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))]),
        max_faces=64, n_points=32, n_sym=2).batched(align=32, device="cpu")
    return jdb, tdb_


def jax_model(cfg, K, TCO, jdb, seed=0):
    model = jpp.PosePredictor(cfg)
    with jpp.skip_render_for_init():
        variables = jax.jit(model.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 96, 128, 3)), jnp.asarray(K)[None],
            jnp.asarray(TCO)[None], jdb.select(jnp.zeros((1,), jnp.int32)))
    return model, jax.tree.map(np.asarray, variables)


def test_render_at_upsampled_renders_match_jax():
    jdb, tdb_ = tiny_world()
    K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)
    TCO = np.eye(4, dtype=np.float32)
    TCO[2, 3] = 0.45
    jm, variables = jax_model(jpp.make_coarse_config(render_size=(48, 64), render_at=(24, 32),
                                                     backbone="resnet18"), K, TCO, jdb)
    tm = tpp.PosePredictor(tpp.make_coarse_config(render_size=(48, 64), render_at=(24, 32), backbone="resnet18"))
    tm.load_state_dict(state_dict_from_jax(variables))
    rng = np.random.RandomState(1)
    T = np.tile(TCO, (3, 1, 1))
    T[:, :3, 3] += rng.normal(scale=0.01, size=(3, 3)).astype(np.float32)
    imgs = rng.uniform(size=(1, 96, 128, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(np.repeat(imgs, 3, 0)), jnp.tile(jnp.asarray(K), (3, 1, 1)),
                    jnp.asarray(T), jdb.select(jnp.zeros((3,), jnp.int32)),
                    method=jpp.PosePredictor.score_views)
    with torch.no_grad():
        got = tm.score_views(torch.as_tensor(imgs), torch.as_tensor(np.tile(K, (3, 1, 1))), torch.as_tensor(T),
                             tdb_.select(torch.zeros(3, dtype=torch.long)))
    r_want, r_got = np.asarray(want["renders"]), got["renders"].numpy()
    assert r_got.shape == r_want.shape == (3, 48, 64, 6)
    d = np.abs(r_got - r_want)
    assert (d < 1e-4).mean() >= 0.99 and np.sort(d.ravel())[-4 * 6 * 3:].min() < 0.05, d.max()
    assert (r_got[..., :3].sum(-1) > 1e-3).mean() > 0.05  # the object is in view
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=0.05)


@pytest.mark.parametrize("name", ["wide_resnet18", "zoo_resnet18"])
def test_wide_and_zoo_backbones_match_jax(name):
    jdb, _ = tiny_world()
    K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)
    TCO = np.eye(4, dtype=np.float32)
    TCO[2, 3] = 0.5
    jm, variables = jax_model(jpp.make_refiner_config(render_size=(32, 48), backbone=name,
                                                      n_rendered_views=1), K, TCO, jdb)
    rng = np.random.RandomState(2)
    if "batch_stats" in variables:  # statistics other than flax's 0 and 1
        variables["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    tm = tpp.PosePredictor(tpp.make_refiner_config(render_size=(32, 48), backbone=name, n_rendered_views=1))
    sd = state_dict_from_jax(variables)
    assert sd.keys() == tm.state_dict().keys()
    tm.load_state_dict(sd)
    x = rng.uniform(size=(2, 32, 48, tm.cfg.n_inputs)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), method=jpp.PosePredictor.net_forward)["pose"])
    with torch.no_grad():
        got = tm.net_forward(torch.as_tensor(x))["pose"].numpy()
        feats = tm.backbone(torch.as_tensor(x))
    assert feats.shape == (2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_demo_world_and_errors_match_jax():
    from megapose6d_tpu.scripts import demo_synthetic_e2e as jdemo
    from megapose6d_tpu_torch.meshes.worlds import build_world
    from megapose6d_tpu_torch.scripts import demo_synthetic_e2e as tdemo

    jw = jdemo.build_world()
    tw = build_world(device="cpu")
    assert tw.labels == tuple(jw.labels)
    for k in ("vertices", "normals", "colors", "faces", "face_valid", "points", "diameters", "uvs",
              "textures", "has_tex"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), atol=1e-6, err_msg=k)
    # The 512-face LOD: the sphere is decimated. The JAX package decimates
    # with its native library where built, which numbers the same vertices
    # and faces in another order, so compare them as sets.
    jl, tl = jdemo.build_world(max_faces=512), build_world(max_faces=512, device="cpu")
    assert tuple(tl.faces.shape) == tuple(jl.faces.shape)
    def triangles(db, i):  # {(position and colour of each corner, sorted)}
        v = np.concatenate([np.asarray(db.vertices[i]), np.asarray(db.colors[i])], -1)
        return {tuple(sorted(map(tuple, np.round(v[t], 6)))) for t in np.asarray(db.faces[i])[np.asarray(db.face_valid[i])]}

    for i in range(2):
        assert triangles(jl, i) == triangles(tl, i)
    from megapose6d_tpu_torch.ops.se3 import rotmat_from_quat

    rng = np.random.RandomState(3)
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, 3] = rng.normal(size=(5, 3)) * 0.1
    T2 = T.copy()
    q = rng.normal(size=(5, 4))
    T2[:, :3, :3] = rotmat_from_quat(torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                                                     dtype=torch.float32)).numpy()
    pts = rng.normal(size=(5, 64, 3)).astype(np.float32) * 0.05
    want = jdemo.pose_errors(T2, T, jnp.asarray(pts))
    got = tdemo.pose_errors(torch.as_tensor(T2), torch.as_tensor(T), torch.as_tensor(pts))
    for w, g, tol in zip(want, got, (1e-6, 1e-4, 1e-6)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol)


def test_demo_draws_match_jax():
    from megapose6d_tpu_torch.scripts import demo_finalize_pipeline as dfp

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(9999), 4)
    got = dfp.eval_draws(2, 16)
    np.testing.assert_array_equal(got["mesh_idx"].numpy(), np.asarray(jax.random.randint(k1, (16,), 0, 2)))
    np.testing.assert_array_equal(got["quat_idx"].numpy(), np.asarray(jax.random.randint(k2, (16,), 0, 4096)))
    np.testing.assert_array_equal(got["z"].numpy(), np.asarray(jax.random.uniform(k3, (16, 1), minval=0.35,
                                                                                     maxval=0.9)))
    np.testing.assert_array_equal(got["xy"].numpy(), np.asarray(jax.random.uniform(k4, (16, 2), minval=-0.05,
                                                                                      maxval=0.05)))
    kr, kt = jax.random.split(jax.random.PRNGKey(7))
    for g, k in zip(dfp.noise_draws(16), (kr, kt)):
        want = np.asarray(jax.random.normal(k, (16, 3)))
        np.testing.assert_array_max_ulp(g.numpy(), want, maxulp=2)
    # The key schedule holds at other sizes and spans too.
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(threefry.randint(threefry.PRNGKey(5), (1000,), 3, 1000),
                                  np.asarray(jax.random.randint(key, (1000,), 3, 1000)))


def test_twin_shares_parameters():
    model = tpp.PosePredictor(tpp.make_coarse_config(render_size=(48, 64), backbone="resnet18",
                                                     compute_dtype="bfloat16"))
    model.init_weights(torch.Generator().manual_seed(0))
    twin = model.twin(compute_dtype="float32", render_at=(24, 32))
    assert twin.cfg.compute_dtype == "float32" and model.cfg.compute_dtype == "bfloat16"
    assert twin.cfg.render_at == (24, 32) and model.cfg.render_at is None
    assert all(a is b for a, b in zip(twin.parameters(), model.parameters()))
    assert twin.state_dict().keys() == model.state_dict().keys()
    with pytest.raises(ValueError):
        model.twin(backbone="resnet34")
    x = torch.rand(2, 48, 64, model.cfg.n_inputs)
    with torch.no_grad():
        f32 = tpp.PosePredictor(tpp.make_coarse_config(render_size=(48, 64), backbone="resnet18"))
        f32.load_state_dict(model.state_dict())
        assert torch.equal(twin.net_forward(x)["renderings_logits"], f32.net_forward(x)["renderings_logits"])
        assert not torch.equal(model.net_forward(x)["renderings_logits"], f32.net_forward(x)["renderings_logits"])
