"""Port vs JAX: the evaluation path (datasets, meters, VSD, the BOP CSV,
the prediction bundle, `run_eval`).

The committed JAX evaluation `runs/full_eval/synthdemo.bop19/gt+SO3_grid`
(gt detections, grid 576, K=4, 3 refiner iterations, on
`runs/ar_dr/synthdemo`) is the target: the JAX package's own meters,
rerun on its `results.*`, reproduce its `summary.json` exactly, so the
port's meters on the same predictions are held to that file:
`n` = 109 exactly; AR_MSSD, AR_MSPD and the ModelNet recalls within one
(instance, threshold) flip (1/1090 for the ARs, 1/109 for a ModelNet
recall); AR_VSD within 0.002. Measured on the CPU: every AR and recall
equal, the medians within 3e-7 relative. On the first 4 frames the JAX
meters run beside the port's (the JAX VSD renders through the interpreted
Pallas kernel are slow): per instance MSSD/MSPD/ADD within rtol 1e-5, the
VSD errors within 2e-3 (a few pixels of a union of ~10^3), and the
summaries as above. Errors on random poses: rtol 1e-5 (f32 sums in
another order). The CSV: byte for byte the JAX writer's.
"""

import dataclasses
import json
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from megapose6d_tpu.data import bop_scene_dataset as jbop
from megapose6d_tpu.data.datasets_cfg import make_object_dataset as jmake_object_dataset
from megapose6d_tpu.data.datasets_cfg import make_scene_dataset as jmake_scene_dataset
from megapose6d_tpu.data.tensor_collection import PandasTensorCollection
from megapose6d_tpu.evaluation import bop as jbop_csv
from megapose6d_tpu.evaluation import meters as jmeters
from megapose6d_tpu.evaluation import vsd as jvsd
from megapose6d_tpu.evaluation.eval_config import EvalConfig as JEvalConfig
from megapose6d_tpu.evaluation.eval_config import FullEvalConfig as JFullEvalConfig
from megapose6d_tpu.evaluation.eval_config import apply_eval_overrides as japply_eval_overrides
from megapose6d_tpu.evaluation.evaluation import load_predictions as jload_predictions
from megapose6d_tpu.evaluation.runner import EvaluationRunner as JEvaluationRunner
from megapose6d_tpu.meshes import MeshDataBase as JMeshDataBase
from megapose6d_tpu_torch.data import bop_scene_dataset as tbop
from megapose6d_tpu_torch.data.datasets_cfg import keep_bop19, make_object_dataset, make_scene_dataset
from megapose6d_tpu_torch.data.tensor_collection import TensorCollection, concatenate
from megapose6d_tpu_torch.evaluation import bop as tbop_csv
from megapose6d_tpu_torch.evaluation import meters as tmeters
from megapose6d_tpu_torch.evaluation import vsd as tvsd
from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig, FullEvalConfig, apply_eval_overrides, get_save_dir
from megapose6d_tpu_torch.evaluation.evaluation import load_predictions, run_eval, save_predictions
from megapose6d_tpu_torch.evaluation.runner import EvaluationRunner
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import run_eval as run_eval_cli
from megapose6d_tpu_torch.scripts import run_full_eval
from tests.test_evaluation import write_synthetic_bop

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "runs/ar_dr"
COMMITTED = ROOT / "runs/full_eval/synthdemo.bop19/gt+SO3_grid"
AR_FLIP = 1 / 1090  # one (instance, threshold) pair of 109 x 10
RECALL_FLIP = 1 / 109


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The meters and `visibility_plain` run many small ops, which gain
    nothing from more threads (21 s for the 109 instances on one, 19 s on
    eight) and slow down ~15x when the test workers' thread pools contend
    for the cores; one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_summary_close(got: dict, want: dict) -> None:
    assert got["bop"]["n"] == want["bop"]["n"] and got["modelnet"]["n"] == want["modelnet"]["n"]
    for k in ("AR_MSSD", "AR_MSPD"):
        assert abs(got["bop"][k] - want["bop"][k]) <= AR_FLIP * 1.0001, (k, got["bop"][k], want["bop"][k])
    assert abs(got["bop"]["AR_VSD"] - want["bop"]["AR_VSD"]) <= 0.002
    assert abs(got["bop"]["AR"] - want["bop"]["AR"]) <= (2 * AR_FLIP + 0.002) / 3 * 1.0001
    for k in ("ADD_0.1d", "5deg_5cm", "proj2d_5px"):
        assert abs(got["modelnet"][k] - want["modelnet"][k]) <= RECALL_FLIP * 1.0001, k
    assert got["modelnet"]["n_missed"] == want["modelnet"]["n_missed"]
    for k in ("mssd_median", "mspd_median"):
        assert got["bop"][k] == pytest.approx(want["bop"][k], rel=1e-5), k


@pytest.fixture(scope="module")
def rescored(tmp_path_factory):
    """The port's `run_eval(skip_inference=True)` on a copy of the
    committed JAX predictions."""
    save = tmp_path_factory.mktemp("eval")
    cfg = EvalConfig(ds_name="synthdemo.bop19", data_dir=str(DATA), save_dir=str(save),
                     skip_inference=True, load_depth=True, device="cpu")
    get_save_dir(cfg).mkdir(parents=True)
    for f in ("results.npz", "results.json"):
        shutil.copy(COMMITTED / f, get_save_dir(cfg) / f)
    return run_eval(cfg), cfg


def test_port_meters_reproduce_committed_summary(rescored):
    out, cfg = rescored
    want = json.loads((COMMITTED / "summary.json").read_text())
    assert out["summary"]["bop"]["n"] == 109
    assert_summary_close(out["summary"], want)
    assert json.loads((get_save_dir(cfg) / "summary.json").read_text()) == out["summary"]
    assert out["pred_keys"] == ["final"] + [f"refiner/iteration={i}" for i in (1, 2, 3)]


def first_frames_predictions(n_frames):
    """The committed final predictions of the dataset's first frames."""
    preds = jload_predictions(COMMITTED / "results.npz")["final"]
    ds = jmake_scene_dataset("synthdemo.bop19", load_depth=True, data_dir=DATA)
    fi = ds.frame_index.iloc[:n_frames]
    frames = {(int(s), int(v)) for s, v in zip(fi.scene_id, fi.view_id)}
    keep = [i for i, r in enumerate(zip(preds.infos.scene_id, preds.infos.view_id)) if r in frames]
    return preds[keep], ds


def test_meters_match_jax_on_first_frames():
    jpreds, jds = first_frames_predictions(4)
    jdb = JMeshDataBase.from_object_ds(jmake_object_dataset("synthdemo.bop19", data_dir=DATA)).batched()
    jm = {"modelnet": jmeters.ModelNetErrorMeter(jdb), "bop": jmeters.BOPScoreMeter(jdb, image_width=320)}
    jsum = JEvaluationRunner(jds, jm).evaluate(jpreds)

    tpreds = TensorCollection(infos={k: jpreds.infos[k].to_numpy() for k in jpreds.infos.columns},
                              poses=torch.as_tensor(np.asarray(jpreds.poses)))
    tdb = MeshDataBase.from_object_ds(make_object_dataset("synthdemo.bop19", data_dir=DATA)).batched(device="cpu")
    tm = {"modelnet": tmeters.ModelNetErrorMeter(tdb), "bop": tmeters.BOPScoreMeter(tdb, image_width=320)}
    tsum = EvaluationRunner(make_scene_dataset("synthdemo.bop19", load_depth=True, data_dir=DATA), tm).evaluate(tpreds)

    assert tsum["bop"]["n"] == jsum["bop"]["n"] == len(jpreds) == 8
    for meter, keys in (("bop", ("mssd", "mspd", "diameter")), ("modelnet", ("add", "rot_err_deg", "proj2d"))):
        for k in keys:
            np.testing.assert_allclose(tm[meter].datas[k], jm[meter].datas[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tm["bop"].datas["vsd"], jm["bop"].datas["vsd"], atol=2e-3)
    for m in ("bop", "modelnet"):
        for k, v in jsum[m].items():
            if "median" in k or k == "add_mean":
                assert tsum[m][k] == pytest.approx(v, rel=1e-5), k
            else:
                assert abs(tsum[m][k] - v) <= (0.002 if k in ("AR_VSD", "AR") else 1e-9), (k, tsum[m][k], v)


def random_poses(rng, n):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.normal(scale=1.0, size=(n, 3))).as_matrix()
    T[:, :3, 3] = np.stack([rng.normal(scale=0.03, size=n), rng.normal(scale=0.03, size=n),
                            rng.uniform(0.4, 0.7, size=n)], -1)
    return T


def test_errors_match_jax_on_random_poses(rng):
    """compute_errors and compute_mssd_mspd on the committed models'
    points and symmetries, at random poses."""
    tdb = MeshDataBase.from_object_ds(make_object_dataset("synthdemo.bop19", data_dir=DATA),
                                      n_sym=8).batched(device="cpu")
    m = tdb.select(torch.as_tensor([0, 1, 1, 0, 1]))
    pts = m.points[:, :300]
    Tp, Tg = random_poses(rng, 5), random_poses(rng, 5)
    K = np.tile(np.asarray([[280.0, 0, 160], [0, 280.0, 120], [0, 0, 1]], np.float32), (5, 1, 1))
    sym = m.symmetries.numpy().copy()
    sym[:, 1, :3, :3] = np.diag([-1.0, -1.0, 1.0])  # a 180-degree symmetry on two slots
    valid = m.sym_valid.numpy().copy()
    valid[:, 1] = [True, False, True, False, True]
    t = lambda x: torch.as_tensor(np.asarray(x))
    a = jmeters.compute_errors(Tp, Tg, pts.numpy(), K, symmetric=np.asarray([1, 0, 1, 0, 0], bool))
    b = tmeters.compute_errors(t(Tp), t(Tg), pts, t(K), symmetric=torch.tensor([1, 0, 1, 0, 0]).bool())
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6, err_msg=k)
    a = jmeters.compute_mssd_mspd(Tp, Tg, pts.numpy(), K, sym, valid)
    b = tmeters.compute_mssd_mspd(t(Tp), t(Tg), pts, t(K), t(sym), t(valid))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)


def test_vsd_matches_jax(bop_root):
    """compute_vsd on the synthetic cube scene (JAX through the interpreted
    kernel, the port through `visibility_plain`), estimates near and far."""
    tobj = tbop.load_bop_object_dataset(bop_root / "models")
    jobj = jbop.load_bop_object_dataset(bop_root / "models")
    tdb = MeshDataBase.from_object_ds(tobj, max_faces=64, n_points=32, n_sym=2).batched(device="cpu")
    jdb = JMeshDataBase.from_object_ds(jobj, max_faces=64, n_points=32, n_sym=2).batched()
    obs = tbop.BOPDataset(bop_root, load_depth=True)[0]
    Tg = np.tile(obs.object_datas[0].TWO.astype(np.float32), (3, 1, 1))
    Tp = Tg.copy()
    Tp[1, 0, 3] += 0.004
    Tp[2, :3, 3] += [0.02, 0.01, 0.05]
    a = jvsd.compute_vsd(obs.depth, Tp, Tg, obs.camera_data.K, jdb.select(jnp.zeros(3, jnp.int32)),
                         np.asarray(jdb.diameters)[[0, 0, 0]])
    b = tvsd.compute_vsd(obs.depth, Tp, Tg, obs.camera_data.K, tdb.select(torch.zeros(3, dtype=torch.long)),
                         tdb.diameters[[0, 0, 0]])
    assert b.shape == (3, 10) and b[0].max() == 0.0 and b[2].min() > 0.1
    np.testing.assert_allclose(b, a, atol=2e-3)
    assert tvsd.vsd_recall(b) == pytest.approx(jvsd.vsd_recall(a), abs=0.002)


def test_match_predictions_matches_jax():
    """Exact key matching, and the greedy fallback with duplicates,
    score order and misses."""
    gt = {"scene_id": [1, 1, 1, 1, 2], "view_id": [0, 0, 0, 0, 3],
          "label": ["a", "a", "b", "c", "a"], "instance_id": [0, 1, 0, 0, 0]}
    exact = {"scene_id": [2, 1, 1, 1, 1], "view_id": [3, 0, 0, 0, 0],
             "label": ["a", "c", "a", "b", "a"], "instance_id": [0, 0, 1, 0, 0],
             "score": [0.1, 0.2, 0.3, 0.4, 0.5]}
    greedy = {"scene_id": [1, 1, 1, 2], "view_id": [0, 0, 0, 3], "label": ["a", "a", "b", "a"],
              "pose_score": [0.2, 0.9, 0.5, 0.4]}
    for pred in (exact, greedy):
        a = jmeters.match_predictions(pd.DataFrame(pred), pd.DataFrame(gt))
        b = tmeters.match_predictions({k: np.asarray(v) for k, v in pred.items()},
                                      {k: np.asarray(v) for k, v in gt.items()})
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tmeters.one_to_one_matching({"label": np.asarray(["a"])}, {"label": np.asarray(["b"])}, keys=("label",))


def committed_final():
    """The committed final predictions, read by the port, and the same
    values as the JAX writer's input."""
    t = load_predictions(COMMITTED / "results.npz")["final"]
    j = PandasTensorCollection(pd.DataFrame({k: v for k, v in t.infos.items()}), poses=t.poses.numpy())
    return t, j


def test_csv_matches_jax_writer(tmp_path):
    t, j = committed_final()
    a = jbop_csv.convert_results_to_bop(j, tmp_path / "jax.csv").read_bytes()
    b = tbop_csv.convert_results_to_bop(t, tmp_path / "port.csv").read_bytes()
    assert a == b
    # Pose columns equal the committed CSV's (written from the in-memory
    # predictions); only score and time went through results.json.
    committed = (COMMITTED / "synthdemo.csv").read_text().splitlines()
    port = b.decode().splitlines()
    assert len(port) == len(committed) == 110 and port[0] == committed[0]
    for x, y in zip(port[1:], committed[1:]):
        x, y = x.split(","), y.split(",")
        assert x[:3] + x[4:6] == y[:3] + y[4:6]
        assert float(x[3]) == pytest.approx(float(y[3]), rel=1e-9, abs=1e-10)
    rows = tbop_csv.load_bop_results(tmp_path / "port.csv")
    assert len(rows) == 109 and rows[0]["R"].shape == (3, 3) and rows[0]["obj_id"] == 2
    assert tbop_csv.label_to_obj_id("ycbv-obj_000002") == 2
    with pytest.raises(ValueError):
        tbop_csv.label_to_obj_id("mug")
    assert tbop_csv.run_bop_evaluation(tmp_path / "port.csv", tmp_path) is None


def assert_same_column(x: np.ndarray, y: np.ndarray, col: str) -> None:
    """Equal, but floats that went through pandas' JSON parser only within
    its last bit (that parser is not correctly rounded)."""
    if x.dtype == object or y.dtype == object:
        assert list(x) == list(y), col
    else:
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=4e-16,
                                   atol=0, err_msg=col)


def test_load_predictions_matches_jax(tmp_path):
    """The committed bundle read by both packages; the port's bundle read
    back by both."""
    j = jload_predictions(COMMITTED / "results.npz")
    t = load_predictions(COMMITTED / "results.npz")
    assert list(t) == list(j)
    for key in j:
        assert list(t[key].infos) == list(j[key].infos.columns)
        np.testing.assert_array_equal(t[key].poses.numpy(), np.asarray(j[key].poses))
        for col in j[key].infos.columns:
            assert_same_column(t[key].infos[col], j[key].infos[col].to_numpy(), col)
    save_predictions(t, tmp_path / "results")
    back, jback = load_predictions(tmp_path / "results.npz"), jload_predictions(tmp_path / "results.npz")
    for key in t:
        np.testing.assert_array_equal(back[key].poses.numpy(), t[key].poses.numpy())
        np.testing.assert_array_equal(np.asarray(jback[key].poses), t[key].poses.numpy())
        for col, x in t[key].infos.items():
            assert list(back[key].infos[col]) == list(x), col  # exact through the port
            assert_same_column(jback[key].infos[col].to_numpy(), x, col)


def test_run_eval_end_to_end(tmp_path):
    """Inference on 2 frames (grid 8, K=1, 1 refiner iteration, the
    committed runs' configurations with seeded weights), the CSV in the
    JAX writer's format, the summary with the JAX summary's keys, the
    bundle readable by the JAX package."""
    argv = [f"data_dir={DATA}", "ds_name=synthdemo.bop19", f"save_dir={tmp_path}", "n_frames=2",
            "coarse_run=runs/coarse_dr", "refiner_run=runs/refiner_dr", "load_depth=1", "device=cpu",
            "so3_grid_size=8", "inference.n_pose_hypotheses=1", "inference.n_refiner_iterations=1",
            "inference.bsz_images=16", "inference.max_detections=2"]
    summary = run_eval_cli.main(argv)
    save = tmp_path / "synthdemo.bop19" / "gt+SO3_grid"
    committed = json.loads((COMMITTED / "summary.json").read_text())
    assert {k: set(v) for k, v in summary.items()} == {k: set(v) for k, v in committed.items()}
    assert summary["bop"]["n"] == 4  # frames 0 and 1, two instances each
    lines = (save / "synthdemo.csv").read_text().splitlines()
    assert lines[0] == (COMMITTED / "synthdemo.csv").read_text().splitlines()[0] and len(lines) == 5
    row = re.compile(r"^\d+,\d+,\d+,[-+.e\d]+,(-?\d+\.\d{8} ){8}-?\d+\.\d{8},(-?\d+\.\d{8} ){2}-?\d+\.\d{8},[.\d]+$")
    assert all(row.match(line) for line in lines[1:]), lines
    j = jload_predictions(save / "results.npz")
    jc = json.loads((COMMITTED / "results.json").read_text())
    assert list(j) == ["final", "refiner/iteration=1"]
    for key in j:
        assert list(j[key].infos.columns) == json.loads(jc[key.replace("/", "__")])["columns"]
    assert len(j["refiner/iteration=1"]) == 4 and (j["refiner/iteration=1"].infos.hypothesis_id == 0).all()
    # Rescoring the saved bundle gives the same summary.
    cfg = apply_eval_overrides(EvalConfig(), [f"data_dir={DATA}", "ds_name=synthdemo.bop19",
                                              f"save_dir={tmp_path}", "skip_inference=true", "load_depth=true",
                                              "device=cpu"])
    assert run_eval(cfg)["summary"] == summary


def test_run_eval_rank_shards_union_equals_world_1(tmp_path):
    """`rank`/`world_size`: the frames split as the JAX package's
    `shard_frames`, and on the first 2 synthdemo frames the union of the
    two ranks' predictions is the world-1 run's (the same rows, poses bit
    for bit on the CPU); `gather_collections` passes one process's
    collection through."""
    from megapose6d_tpu.evaluation.runner import shard_frames as j_shard_frames
    from megapose6d_tpu_torch.evaluation.runner import shard_frames
    from megapose6d_tpu_torch.parallel.distributed import gather_collections

    for n, world in ((7, 2), (56, 3), (2, 2)):
        for rank in range(world):
            np.testing.assert_array_equal(shard_frames(n, rank, world), j_shard_frames(n, rank, world))
    scene_ds = make_scene_dataset("synthdemo.bop19", load_depth=False, data_dir=str(DATA))
    scene_ds.frame_index = scene_ds.frame_index.take(np.arange(2))
    base = [f"data_dir={DATA}", "ds_name=synthdemo.bop19", "coarse_run=runs/coarse_dr", "refiner_run=runs/refiner_dr",
            "device=cpu", "inference.SO3_grid_size=8", "inference.n_pose_hypotheses=1",
            "inference.n_refiner_iterations=1", "inference.bsz_images=16", "skip_evaluation=true"]
    finals = {}
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        cfg = apply_eval_overrides(EvalConfig(), base + [f"save_dir={tmp_path / f'{rank}of{world}'}",
                                                         f"rank={rank}", f"world_size={world}"])
        finals[rank, world] = load_predictions(run_eval(cfg, scene_ds=scene_ds)["results_path"])["final"]
    assert all(len(finals[r, 2]) for r in range(2))
    union = concatenate([finals[0, 2], finals[1, 2]])
    whole = finals[0, 1]
    for k in ("scene_id", "view_id", "label"):
        assert union.infos[k].tolist() == whole.infos[k].tolist(), k
    assert torch.equal(union.poses, whole.poses)
    assert gather_collections(whole) is whole


def test_eval_overrides():
    cfg = apply_eval_overrides(EvalConfig(), ["inference.SO3_grid_size=72", "n_frames=3", "render_size=48,64",
                                              "save_dir=x", "skip_inference=1"])
    assert cfg.inference.SO3_grid_size == 72 and cfg.n_frames == 3 and cfg.render_size == (48, 64)
    assert cfg.skip_inference and get_save_dir(cfg) == Path("x/ycbv.bop19/gt+SO3_grid")
    for bad in (["nope=1"], ["inference.nope=1"], ["n_frames"]):
        with pytest.raises(ValueError):
            apply_eval_overrides(EvalConfig(), bad)


EVAL_DOTLISTS = [
    [],
    ["hardware.n_cpus=4", "hardware.n_chips=2", "debug=1", "result_id=abc", "n_dataloader_workers=3",
     "global_batch_size=16", "n_frames=5", "inference.SO3_grid_size=72", "render_size=48,64", "skip_evaluation=true"],
    ["run_bop_eval=1", "bop_toolkit_dir=/opt/bop_toolkit", "modelnet_categories=chair,mug", "ds_names=a.bop19,b",
     "detection_coarse_types=gt:SO3_grid,detector:SO3_grid", "hardware.n_cpus=2", "debug=true"],
    ['modelnet_categories=["bottle", "can"]', "world_size=2", "rank=1", "load_depth=1"],
]


@pytest.mark.parametrize("full", [False, True], ids=["eval", "full_eval"])
@pytest.mark.parametrize("argv", EVAL_DOTLISTS, ids=["defaults", "eval_keys", "full_keys", "lists"])
def test_eval_overrides_match_jax(full, argv):
    """Every field of the JAX package's configurations exists in the port
    and takes the same value from the same dotlist (the inference
    configuration: the fields the dotlist sets)."""
    if not full and any(a.split("=")[0] in ("run_bop_eval", "bop_toolkit_dir", "modelnet_categories", "ds_names",
                                            "detection_coarse_types") for a in argv):
        with pytest.raises(ValueError):
            apply_eval_overrides(EvalConfig(), argv)
        return
    j = japply_eval_overrides(JFullEvalConfig() if full else JEvalConfig(), argv)
    t = apply_eval_overrides(FullEvalConfig() if full else EvalConfig(), argv)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    for k, v in jd.items():
        if k == "inference":
            continue
        assert k in td, k
        assert td[k] == v or (isinstance(v, list) and [tuple(x) if isinstance(x, list) else x for x in td[k]]
                              == [tuple(x) if isinstance(x, list) else x for x in v]), k
    for a in argv:
        if a.startswith("inference."):
            f = a.split("=")[0].split(".")[1]
            assert getattr(t.inference, f) == getattr(j.inference, f)


def test_run_full_eval_scores_with_bop_toolkit(tmp_path):
    """`run_bop_eval=1`: each BOP19 dataset's results CSV goes to
    bop_toolkit's script, as the JAX sweep sends it (a stand-in script
    records its arguments); without the toolkit nothing is scored."""
    toolkit = tmp_path / "bop_toolkit"
    (toolkit / "scripts").mkdir(parents=True)
    for name in ("eval_bop19.py", "eval_bop19_dummy.py"):
        (toolkit / "scripts" / name).write_text(
            "import json, pathlib, sys\n"
            f"pathlib.Path(sys.argv[sys.argv.index('--eval_path') + 1], '{name}.json').parent.mkdir(parents=True, "
            "exist_ok=True)\n"
            f"pathlib.Path(sys.argv[sys.argv.index('--eval_path') + 1], '{name}.json').write_text(json.dumps("
            "sys.argv[1:]))\n")
    key = "synthdemo.bop19/gt+SO3_grid"
    seen = {}
    for name in ("jax", "port", "port_no_toolkit"):
        shutil.copytree(COMMITTED, tmp_path / name / key)
        argv = ["ds_names=synthdemo.bop19", f"save_dir={tmp_path / name}", "skip_inference=1", "run_bop_eval=1",
                "debug=1"] + ([] if name == "port_no_toolkit" else [f"bop_toolkit_dir={toolkit}"])
        if name == "jax":
            from megapose6d_tpu.scripts.run_full_eval import run_full_eval as jrun_full_eval

            jrun_full_eval(japply_eval_overrides(JFullEvalConfig(), argv))
        else:
            run_full_eval.main(argv)
        out = tmp_path / name / key / "bop_evaluation" / "eval_bop19_dummy.py.json"
        seen[name] = json.loads(out.read_text()) if out.exists() else None
    assert seen["port_no_toolkit"] is None
    assert seen["jax"] is not None
    assert [a.replace("/port/", "/jax/") for a in seen["port"]] == seen["jax"]


@pytest.fixture(scope="module")
def bop_root(tmp_path_factory):
    return write_synthetic_bop(tmp_path_factory.mktemp("bop") / "cubeds")


def test_bop_dataset_matches_jax(bop_root):
    """The synthetic BOP tree and the committed synthdemo frames, read by
    both packages (depth in meters, masks, boxes, poses)."""
    for root, views in ((bop_root, range(6)), (DATA / "synthdemo", range(0, 56, 11))):
        j = jbop.BOPDataset(root, load_depth=True)
        t = tbop.BOPDataset(root, load_depth=True)
        assert list(t.frame_index.scene_id) == list(j.frame_index.scene_id)
        assert list(t.frame_index.view_id) == list(j.frame_index.view_id)
        for i in views:
            a, b = j[i], t[i]
            for k in ("rgb", "depth", "segmentation"):
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            np.testing.assert_array_equal(a.camera_data.K, b.camera_data.K)
            assert a.infos.scene_id == b.infos.scene_id and a.infos.view_id == b.infos.view_id
            assert len(a.object_datas) == len(b.object_datas)
            for x, y in zip(a.object_datas, b.object_datas):
                assert x.label == y.label and x.visib_fract == y.visib_fract
                for k in ("TWO", "bbox_modal", "bbox_amodal"):
                    np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
    jo, to = jbop.load_bop_object_dataset(bop_root / "models"), tbop.load_bop_object_dataset(bop_root / "models")
    assert to.labels == jo.labels
    np.testing.assert_array_equal(to.objects[0].symmetries_discrete[0].pose, jo.objects[0].symmetries_discrete[0].pose)


def test_dataset_names(bop_root, tmp_path):
    ds = make_scene_dataset("cubeds.bop19", data_dir=bop_root.parent, n_frames=4)
    assert len(ds) == 4 and ds[3].infos.view_id == 0 and ds[3].infos.scene_id == "000001"
    assert make_object_dataset("cubeds.bop19", data_dir=bop_root.parent).labels == ["obj_000001"]
    (bop_root / "test_targets_bop19.json").write_text(json.dumps(
        [{"scene_id": 1, "im_id": 2, "obj_id": 1, "inst_count": 1},
         {"scene_id": 0, "im_id": 1, "obj_id": 1, "inst_count": 1}]))
    try:
        kept = make_scene_dataset("cubeds.bop19", data_dir=bop_root.parent)
        j = jbop.BOPDataset(bop_root)
        from megapose6d_tpu.data.datasets_cfg import keep_bop19 as jkeep_bop19
        jk = jkeep_bop19(j)
        assert list(zip(kept.frame_index.scene_id, kept.frame_index.view_id)) == \
            list(zip(jk.frame_index.scene_id, jk.frame_index.view_id)) == [("000000", 1), ("000001", 2)]
        assert len(keep_bop19(tbop.BOPDataset(bop_root))) == 2
    finally:
        (bop_root / "test_targets_bop19.json").unlink()
    # Every name resolves now (tests/test_torch_datasets_cfg.py); without its data each raises.
    for name in ("webdataset.x", "modelnet.bathtub.test", "ycbv.bop19"):
        with pytest.raises(FileNotFoundError):
            make_scene_dataset(name, data_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        make_object_dataset("gso.orig", data_dir=tmp_path)
    with pytest.raises(ValueError):
        make_object_dataset("nothing_here.bop19", data_dir=tmp_path)
    with pytest.raises(ValueError):
        make_scene_dataset("cubeds.pbr", data_dir=bop_root.parent)


def test_tensor_collection():
    a = TensorCollection(infos={"label": ["x", "y"], "score": [0.5, 0.25]}, poses=torch.zeros(2, 4, 4))
    b = TensorCollection(infos={"label": ["z"], "score": [0.75]}, poses=torch.ones(1, 4, 4))
    c = concatenate([a, b])
    assert c.labels == ["x", "y", "z"] and c.infos["score"].tolist() == [0.5, 0.25, 0.75]
    assert list(c.infos) == ["label", "score"] and c.poses.shape == (3, 4, 4)
    sel = c[[2, 0]]
    assert sel.labels == ["z", "x"] and sel.poses[0, 0, 0] == 1 and sel.infos["score"][1] == 0.5
    assert c[np.asarray([False, True, False])].labels == ["y"]
    with pytest.raises(ValueError):
        TensorCollection(["x"], poses=torch.zeros(2, 4, 4))
    with pytest.raises(ValueError):
        concatenate([a, TensorCollection(["q"], poses=torch.zeros(1, 4, 4))])
