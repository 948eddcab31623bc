"""Visualization: detections, pose overlays, silhouette contours, image
grids, drawn in numpy and written through `utils/png.py`.

Counterpart of `megapose6d_tpu/visualization/plotter.py`, which draws
with matplotlib and PIL; neither is on the card's machine, so boxes and
labels are drawn here into a `uint8` image with a 5x7 bitmap font kept in
this module, and `plot_detections` returns that image where the JAX
function returns a matplotlib figure. Pose overlays render the estimated
poses with the scan renderer (`ops/rasterizer.py`), as the JAX function
does, on the mesh database's device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.png import write_png

# 5x7 glyphs, one hex byte per row (top first), bit 4 the leftmost column.
# Lower-case letters are drawn with the upper-case glyphs.
_FONT = {
    "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010204081F", "3": "1F02040201110E",
    "4": "02060A121F0202", "5": "1F101E0101110E", "6": "0608101E11110E", "7": "1F010204080808",
    "8": "0E11110E11110E", "9": "0E11110F01020C", "A": "0E11111F111111", "B": "1E11111E11111E",
    "C": "0E11101010110E", "D": "1C12111111121C", "E": "1F10101E10101F", "F": "1F10101E101010",
    "G": "0E11101711110F", "H": "1111111F111111", "I": "0E04040404040E", "J": "0702020202120C",
    "K": "11121418141211", "L": "1010101010101F", "M": "111B1515111111", "N": "11111915131111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D", "R": "1E11111E141211",
    "S": "0F10100E01011E", "T": "1F040404040404", "U": "1111111111110E", "V": "11111111110A04",
    "W": "1111111515150A", "X": "11110A040A1111", "Y": "1111110A040404", "Z": "1F01020408101F",
    "_": "0000000000001F", "-": "0000001F000000", ".": "00000000000C0C", ":": "000C0C000C0C00",
    "/": "00010204081000", " ": "00000000000000", "(": "02040808080402", ")": "08040202020408",
    "+": "0004041F040400", "=": "00001F001F0000", ",": "000000000C0408", "%": "18190204081303",
    "?": "0E110102040004",
}
GLYPH_W, GLYPH_H = 5, 7
LIME = (0, 255, 0)


def _glyph(ch: str) -> np.ndarray:
    """The `[7, 5]` bool bitmap of `ch` ('?' for a character the font lacks)."""
    rows = bytes.fromhex(_FONT.get(ch.upper(), _FONT["?"]))
    return np.array([[(r >> (4 - c)) & 1 for c in range(GLYPH_W)] for r in rows], bool)


def draw_text(img: np.ndarray, x: int, y: int, text: str, color=LIME) -> np.ndarray:
    """Draw `text` into `img [H, W, 3]` uint8 in place, its top-left
    corner at pixel (x, y), one column between glyphs; what falls outside
    the image is clipped."""
    H, W = img.shape[:2]
    for i, ch in enumerate(text):
        g = _glyph(ch)
        gx = x + i * (GLYPH_W + 1)
        ys, xs = np.nonzero(g)
        ys, xs = ys + y, xs + gx
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[keep], xs[keep]] = color
    return img


def draw_box(img: np.ndarray, box, color=LIME, width: int = 2) -> np.ndarray:
    """Draw the outline of `box` (x1, y1, x2, y2 in pixels) into `img` in
    place, `width` pixels thick inward, clipped to the image."""
    H, W = img.shape[:2]
    x1, y1, x2, y2 = (int(round(float(v))) for v in box)
    for k in range(width):
        xa, xb = max(x1 + k, 0), min(x2 - k, W - 1)
        ya, yb = max(y1 + k, 0), min(y2 - k, H - 1)
        if xa > xb or ya > yb:
            break
        for yy in (y1 + k, y2 - k):
            if 0 <= yy < H:
                img[yy, xa:xb + 1] = color
        for xx in (x1 + k, x2 - k):
            if 0 <= xx < W:
                img[ya:yb + 1, xx] = color
    return img


def _to_uint8(img) -> np.ndarray:
    img = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def plot_detections(rgb, detections, out_path: str | Path | None = None) -> np.ndarray:
    """The image `rgb [H, W, 3]` (uint8, or float in [0, 1]) with each
    detection's box (lime, 2 px) and its label above the box's top-left
    corner. `detections`: a `TensorCollection` with `bboxes [D, 4]` and a
    `label` column. Returns the `uint8 [H, W, 3]` image; writes it to
    `out_path` as PNG when given."""
    img = np.ascontiguousarray(_to_uint8(rgb)[..., :3]).copy()
    boxes = detections.bboxes
    boxes = boxes.detach().cpu().numpy() if torch.is_tensor(boxes) else np.asarray(boxes)
    for box, label in zip(boxes, detections.infos["label"]):
        draw_box(img, box)
        draw_text(img, int(round(float(box[0]))), int(round(float(box[1]))) - 3 - GLYPH_H, str(label))
    if out_path:
        write_png(out_path, img)
    return img


def plot_pose_overlay(
    rgb,
    mesh_db,
    labels: list[str],
    poses,
    K,
    out_path: str | Path | None = None,
    alpha: float = 0.6,
    contour_out_path: str | Path | None = None,
) -> np.ndarray:
    """Renders of the estimated `poses [N, 4, 4]` of `labels` (scan
    renderer, the mesh database's device) blended over the observation
    with weight `alpha`; returns the `uint8` overlay. `contour_out_path`
    also writes the silhouette contour of the renders' union over the
    image (`make_contour_overlay`)."""
    from ..ops import rasterizer

    H, W = np.asarray(_to_uint8(rgb)).shape[:2]
    dev = mesh_db.device
    meshes = mesh_db.select(mesh_db.label_to_index(labels))
    B = len(labels)
    out = rasterizer.render_meshes(
        meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid,
        torch.as_tensor(np.asarray(poses.cpu() if torch.is_tensor(poses) else poses), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(np.asarray(K.cpu() if torch.is_tensor(K) else K), dtype=torch.float32,
                        device=dev).expand(B, 3, 3),
        (H, W),
    )
    mask, rend = out.mask.cpu().numpy(), out.rgb.cpu().numpy()
    overlay = _to_uint8(rgb).astype(np.float32) / 255.0
    for b in range(B):
        overlay = np.where(mask[b][..., None], (1 - alpha) * overlay + alpha * rend[b], overlay)
    overlay = _to_uint8(overlay)
    if out_path:
        write_png(out_path, overlay)
    if contour_out_path is not None:
        make_contour_overlay(rgb, mask.any(axis=0), out_path=contour_out_path)
    return overlay


def save_image_grid(images: list, out_path: str | Path, n_cols: int = 4) -> np.ndarray:
    """Tile images (uint8, or float in [0, 1]; grey or colour) row-major
    into a grid of `n_cols` columns of the largest image's size, written
    as PNG; returns the grid."""
    images = [_to_uint8(im) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    n_rows = (len(images) + n_cols - 1) // n_cols
    grid = np.zeros((n_rows * h, n_cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, n_cols)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        grid[r * h : r * h + im.shape[0], c * w : c * w + im.shape[1]] = im[..., :3]
    write_png(out_path, grid)
    return grid


def make_contour_overlay(rgb, mask, color=(0, 255, 0), thickness: int = 2,
                         out_path: str | Path | None = None) -> np.ndarray:
    """The silhouette contour of `mask [H, W]` drawn in `color` over the
    observation: a morphological gradient (dilation minus erosion by a
    square of half-width `thickness`, wrapping at the borders as
    `np.roll` does)."""
    img = _to_uint8(rgb).copy()
    m = (mask.cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)).astype(bool)
    if m.ndim == 3:
        m = m[..., 0]

    def shift_or(a, k):
        out = np.zeros_like(a)
        for dv in range(-k, k + 1):
            for du in range(-k, k + 1):
                out |= np.roll(np.roll(a, dv, axis=0), du, axis=1)
        return out

    edge = shift_or(m, thickness) & shift_or(~m, thickness)
    img[edge] = np.asarray(color, np.uint8)
    if out_path:
        write_png(out_path, img)
    return img
