"""Port vs JAX (PIL): the training augmentations without PIL.

`utils/imaging.py` against PIL itself (resize BILINEAR and BICUBIC on
uint8, BILINEAR and NEAREST on float32, NEAREST on int32, GaussianBlur,
SMOOTH, convert("L") and every ImageEnhance blend), then every transform
of `data/augmentations.py` against the JAX package's on the same seeded
observations, with `random` and `np.random` seeded alike for both.

Tolerance: none. Every output is held bit for bit (rgb, depth,
segmentation, K, boxes), and both packages must leave the global `random`
and `np.random` streams in the same state (the same draws, in the same
order). `DepthBlurTransform` raises in both (PIL refuses float images).
"""

import dataclasses
import random

import numpy as np
import PIL.Image as Image
import PIL.ImageEnhance as ImageEnhance
import PIL.ImageFilter as ImageFilter
import pytest

from megapose6d_tpu.data import augmentations as ja
from megapose6d_tpu.data.scene_dataset import ObservationInfos as JInfos
from megapose6d_tpu.data.scene_dataset import SceneObservation as JObs
from megapose6d_tpu.data.types import CameraData as JCam
from megapose6d_tpu.data.types import ObjectData as JObj
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.data import augmentations as ta
from megapose6d_tpu_torch.data.scene_dataset import ObservationInfos as TInfos
from megapose6d_tpu_torch.data.scene_dataset import SceneObservation as TObs
from megapose6d_tpu_torch.data.types import CameraData as TCam
from megapose6d_tpu_torch.data.types import ObjectData as TObj
from megapose6d_tpu_torch.utils import imaging


def _image(rng, h, w, smooth):
    if smooth:  # a photo-like image: neighbours close, so rounding ties occur
        return np.clip(np.cumsum(rng.randint(-20, 21, (h, w, 3)), 1) + 128, 0, 255).astype(np.uint8)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


SIZES = [(17, 23, 40, 31), (48, 64, 24, 32), (480, 640, 240, 320), (90, 120, 121, 161), (33, 80, 7, 5)]


@pytest.mark.parametrize("h,w,oh,ow", SIZES)
def test_imaging_resizes_match_pil(h, w, oh, ow):
    rng = np.random.RandomState(h * w)
    for smooth in (False, True):
        a = _image(rng, h, w, smooth)
        for method, pil in (("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC)):
            np.testing.assert_array_equal(imaging.resize(a, (oh, ow), method),
                                          np.array(Image.fromarray(a).resize((ow, oh), pil)), err_msg=method)
        np.testing.assert_array_equal(imaging.resize(a, (oh, ow), "bicubic"),
                                      np.array(Image.fromarray(a).resize((ow, oh))))  # PIL's default
    f = rng.normal(size=(h, w)).astype(np.float32)
    np.testing.assert_array_equal(imaging.resize(f, (oh, ow)), np.array(Image.fromarray(f).resize((ow, oh),
                                                                                                  Image.BILINEAR)))
    np.testing.assert_array_equal(imaging.resize_nearest(f, (oh, ow)),
                                  np.array(Image.fromarray(f).resize((ow, oh), Image.NEAREST)))
    s = rng.randint(0, 7, (h, w)).astype(np.int32)
    np.testing.assert_array_equal(imaging.resize_nearest(s, (oh, ow)),
                                  np.array(Image.fromarray(s).resize((ow, oh), Image.NEAREST)))


@pytest.mark.parametrize("h,w", [(5, 7), (24, 32), (61, 83), (240, 320)])
def test_imaging_filters_and_blends_match_pil(h, w):
    rng = np.random.RandomState(h + w)
    for smooth in (False, True):
        a = _image(rng, h, w, smooth)
        for r in (1, 2, 3, 5, 7):
            np.testing.assert_array_equal(imaging.gaussian_blur(a, r),
                                          np.array(Image.fromarray(a).filter(ImageFilter.GaussianBlur(r))))
        np.testing.assert_array_equal(imaging.smooth(a), np.array(Image.fromarray(a).filter(ImageFilter.SMOOTH)))
        np.testing.assert_array_equal(imaging.luma(a), np.array(Image.fromarray(a).convert("L")))
        for cls in (ta.PillowSharpness, ta.PillowContrast, ta.PillowBrightness, ta.PillowColor):
            enhancer = getattr(ImageEnhance, cls.__name__[len("Pillow"):])
            for factor in (0.0, 0.37, 1.0, 2.9, 17.3, rng.uniform(0, 50)):
                np.testing.assert_array_equal(imaging.blend(cls.degenerate(a), a, factor),
                                              np.array(enhancer(Image.fromarray(a)).enhance(factor)),
                                              err_msg=f"{cls.__name__} {factor}")
    with pytest.raises(ValueError, match="wrong mode"):
        Image.fromarray(np.zeros((h, w), np.float32)).filter(ImageFilter.GaussianBlur(3))
    with pytest.raises(ValueError, match="wrong mode"):
        imaging.gaussian_blur(np.zeros((h, w), np.float32), 3)


def _obs_pair(seed, h=96, w=128, n_objects=3):
    """The same observation in both packages' types: a smooth image, depth
    with holes, a segmentation of `n_objects` rectangles."""
    rng = np.random.RandomState(seed)
    rgb = _image(rng, h, w, smooth=seed % 2 == 0)
    depth = rng.uniform(0.3, 1.2, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0
    seg = np.zeros((h, w), np.uint32)
    boxes = []
    for i in range(n_objects):
        y0, x0 = rng.randint(0, h - 20), rng.randint(0, w - 20)
        y1, x1 = y0 + rng.randint(5, 20), x0 + rng.randint(5, 20)
        seg[y0:y1, x0:x1] = i + 1
        boxes.append(np.array([x0, y0, x1, y1], np.float64))
    K = np.array([[150.0, 0, w / 2 - 0.5], [0, 151.0, h / 2 + 0.5], [0, 0, 1]])
    pair = []
    for Obs, Obj, Cam, Infos in ((JObs, JObj, JCam, JInfos), (TObs, TObj, TCam, TInfos)):
        objs = [Obj(label=f"obj_{i:06d}", TWO=np.eye(4), unique_id=i + 1, bbox_modal=boxes[i].copy(),
                    visib_fract=0.5) for i in range(n_objects)]
        pair.append(Obs(rgb=rgb.copy(), depth=depth.copy(), segmentation=seg.copy(), infos=Infos("0", seed),
                        object_datas=objs, camera_data=Cam(K=K.copy(), resolution=(h, w))))
    return pair


def _apply(transform, obs, seed):
    random.seed(seed)
    np.random.seed(seed)
    try:
        out = transform(obs)
    except ValueError as e:
        out = e
    return out, random.random(), np.random.random()


def _same(a, b):
    if isinstance(a[0], Exception) or isinstance(b[0], Exception):
        assert type(a[0]) is type(b[0]) and str(a[0]) == str(b[0])
    else:
        x, y = a[0], b[0]
        for k in ("rgb", "depth", "segmentation"):
            u, v = getattr(x, k), getattr(y, k)
            assert (u is None) == (v is None), k
            if u is not None:
                assert u.dtype == v.dtype, k
                np.testing.assert_array_equal(u, v, err_msg=k)
        np.testing.assert_array_equal(x.camera_data.K, y.camera_data.K)
        assert tuple(x.camera_data.resolution) == tuple(y.camera_data.resolution)
        for o, p in zip(x.object_datas, y.object_datas, strict=True):
            assert (o.bbox_modal is None) == (p.bbox_modal is None)
            if o.bbox_modal is not None:
                np.testing.assert_array_equal(o.bbox_modal, p.bbox_modal)
    assert a[1:] == b[1:], "the global random streams moved differently"


TRANSFORMS = {
    "blur": lambda m: m.PillowBlur((1, 3)),
    "sharpness": lambda m: m.PillowSharpness(),
    "contrast": lambda m: m.PillowContrast(),
    "contrast_low": lambda m: m.PillowContrast((0.0, 1.0)),
    "brightness": lambda m: m.PillowBrightness(),
    "color": lambda m: m.PillowColor(),
    "depth_noise": lambda m: m.DepthGaussianNoiseTransform(0.01),
    "depth_correlated": lambda m: m.DepthCorrelatedGaussianNoiseTransform(0.01),
    "depth_missing": lambda m: m.DepthMissingTransform(0.2),
    "depth_dropout": lambda m: m.DepthDropoutTransform(),
    "depth_ellipse_dropout": lambda m: m.DepthEllipseDropoutTransform(),
    "depth_ellipse_noise": lambda m: m.DepthEllipseNoiseTransform(),
    "depth_blur": lambda m: m.DepthBlurTransform(),
    "depth_background": lambda m: m.DepthBackgroundDropoutTransform(),
    "crop_240x320": lambda m: m.CropResizeToAspectTransform((240, 320)),
    "crop_60x80": lambda m: m.CropResizeToAspectTransform((60, 80)),
    "crop_tall": lambda m: m.CropResizeToAspectTransform((64, 40)),
    "crop_same": lambda m: m.CropResizeToAspectTransform((96, 128)),
    "obs_aug_list": lambda m: m.SceneObsAug([m.PillowBlur(), m.PillowBrightness()], p=0.5),
    "rgb_stack": lambda m: m.make_rgb_augmentations(),
    "depth_stack": lambda m: m.make_depth_augmentations(),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    for seed in range(6):
        h, w = [(96, 128), (100, 200), (120, 90)][seed % 3]
        jo, to = _obs_pair(seed, h, w)
        _same(_apply(TRANSFORMS[name](ja), jo, seed), _apply(TRANSFORMS[name](ta), to, seed))


def test_crop_resize_drops_vanished_boxes():
    jo, to = _obs_pair(3, 96, 128)
    for o in (jo, to):  # object 2 only in the top rows, which the crop to 3:8 removes
        o.segmentation[o.segmentation == 2] = 0
        o.segmentation[0:10, 40:50] = 2
    _same(_apply(ja.CropResizeToAspectTransform((60, 160)), jo, 0),
          _apply(ta.CropResizeToAspectTransform((60, 160)), to, 0))
    assert ta.CropResizeToAspectTransform((60, 160))(to).object_datas[1].bbox_modal is None


@pytest.mark.parametrize("kind", ["rgb_png", "grey_png", "rgba_png", "jpeg"])
def test_background_replacement_matches_jax(tmp_path, kind):
    if kind == "jpeg" and not native.available():
        pytest.skip("JPEG needs the native decoder (g++, libjpeg), which did not build")
    rng = np.random.RandomState(5)
    paths = []
    for i, (h, w) in enumerate([(50, 70), (130, 90), (96, 128)]):
        img = _image(rng, h, w, smooth=True)
        if kind == "grey_png":
            img = img[..., 0]
        elif kind == "rgba_png":
            img = np.concatenate([img, rng.randint(0, 256, (h, w, 1)).astype(np.uint8)], -1)
        if kind == "jpeg":
            (tmp_path / "JPEGImages").mkdir(exist_ok=True)
            path = tmp_path / "JPEGImages" / f"{i}.jpg"
            Image.fromarray(img).save(path, quality=90)
        else:
            path = tmp_path / f"{i}.png"
            Image.fromarray(img).save(path)
        paths.append(path)
    for seed in range(4):
        jo, to = _obs_pair(seed)
        if kind == "jpeg":
            jt, tt = ja.VOCBackgroundAugmentation(tmp_path), ta.VOCBackgroundAugmentation(tmp_path)
        else:
            jt, tt = ja.ReplaceBackgroundTransform(paths), ta.ReplaceBackgroundTransform(paths)
        _same(_apply(jt, jo, seed), _apply(tt, to, seed))


def test_transforms_keep_the_input():
    """A transform returns a new observation and leaves its input as it was."""
    _, to = _obs_pair(4)
    before = dataclasses.replace(to, rgb=to.rgb.copy(), depth=to.depth.copy())
    for make in TRANSFORMS.values():
        _apply(make(ta), to, 1)
        np.testing.assert_array_equal(to.rgb, before.rgb)
        np.testing.assert_array_equal(to.depth, before.depth)
