"""The port's scene loader (seal3d_tpu_torch/data/provider.py) without cv2:
its zlib PNG reader against cv2.imread, bit for bit, on the Blender
fixture's PNGs and on generated 8-bit gray, RGB and RGBA PNGs under each of
the five scanline filters (written by this file's own encoder); the port's
PNG writer read back by both; the reader's named errors; the block-mean
downscale against cv2.INTER_AREA at integer factors (within 1 uint8
level); `NeRFDataset.load` of tests/fixtures/blender_micro in both
packages (poses to 1e-6, intrinsics and images equal) and with cv2 hidden
(the same pixels); an unreadable frame raises; a few train steps of the
port's CLI on the fixture."""

import functools
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from seal3d_tpu.data.provider import NeRFDataset as JDataset
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.data import provider as tprov
from seal3d_tpu_torch.data.provider import (ImageReadError, NeRFDataset,
                                            area_downscale,
                                            nerf_matrix_to_ngp,
                                            ngp_to_nerf_matrix, read_png)
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.train.video import write_png

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "blender_micro")
CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cv2_rgb(path):
    """cv2.imread(IMREAD_UNCHANGED) in RGB(A) order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]
    return img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(img, filt, ctype=None, depth=8, interlace=0, bad_crc=False):
    """A PNG of uint8 img [H, W(, C)] with every row under filter `filt`
    (0-4), or filter r % 5 on row r for 'cycle'; written byte by byte, apart
    from the package's writer."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(int)
    out = bytearray()
    for r in range(h):
        f = r % 5 if filt == "cycle" else filt
        out.append(f)
        for i in range(w * c):
            a = x[r, i - c] if i >= c else 0
            b = x[r - 1, i] if r > 0 else 0
            cc = x[r - 1, i - c] if r > 0 and i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[f]
            out.append((x[r, i] - pred) & 0xFF)

    ctype = {1: 0, 3: 2, 4: 6}[c] if ctype is None else ctype
    return _assemble(w, h, ctype, bytes(out), depth, interlace, bad_crc)


def _assemble(w, h, ctype, scanlines, depth=8, interlace=0, bad_crc=False):
    """Signature, IHDR, one IDAT of the deflated scanlines, IEND."""
    def chunk(kind, data):
        crc = zlib.crc32(kind + data) ^ (1 if bad_crc else 0)
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", crc)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(scanlines, 9))
            + chunk(b"IEND", b""))


def _image(kind, h=13, w=17, seed=0):
    """Random pixels with smooth runs, so every filter sees carries and
    wraps."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if kind == "gray" else (h, w, CHANNELS[kind])
    ramp = np.add.outer(np.arange(h) * 37, np.arange(w) * 11) % 256
    noise = rng.integers(0, 256, shape)
    img = np.where(rng.random(shape) < 0.5, noise,
                   ramp if kind == "gray" else ramp[..., None])
    return img.astype(np.uint8)


def test_read_png_matches_cv2_on_the_fixture():
    names = sorted(f for f in os.listdir(FIXTURE) if f.endswith(".png"))
    assert len(names) == 6
    for name in names:
        path = os.path.join(FIXTURE, name)
        got, want = read_png(path), _cv2_rgb(path)
        assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "cycle"])
@pytest.mark.parametrize("kind", list(CHANNELS))
def test_read_png_matches_cv2_for_each_filter(tmp_path, kind, filt):
    img = _image(kind, seed=CHANNELS[kind])
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_encode(img, filt))
    got = read_png(path)
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", list(CHANNELS))
def test_port_png_writer_reads_back_in_both(tmp_path, kind):
    """write_png picks a filter per row; read_png and cv2 read its file."""
    img = _image(kind, h=40, w=33, seed=7)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)


def test_read_png_rejects_what_it_does_not_read(tmp_path):
    img = _image("rgb")
    cases = {
        "sixteen_bit": _encode(img, 0, depth=16),
        "palette": _encode(img[..., 0], 0, ctype=3),
        "interlaced": _encode(img, 0, interlace=1),
        "bad_crc": _encode(img, 0, bad_crc=True),
        "truncated": _encode(img, 0)[:-30],
        "not_png": b"GIF89a" + bytes(40),
    }
    # row 3 names filter type 9
    cases["filter_type_9"] = _assemble(17, 13, 2, b"".join(
        bytes([9 if r == 3 else 0]) + bytes(17 * 3) for r in range(13)))
    for name, blob in cases.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(ImageReadError):
            read_png(path)
    with pytest.raises(ImageReadError, match="row 3"):
        read_png(str(tmp_path / "filter_type_9.png"))
    with pytest.raises(ImageReadError):
        read_png(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("kind", list(CHANNELS))
def test_area_downscale_matches_cv2_inter_area(kind, factor):
    img = _image(kind, h=16 * factor, w=12 * factor, seed=factor)
    got = area_downscale(img, 16, 12)
    want = cv2.resize(img, (12, 16), interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    with pytest.raises(ImageReadError):
        area_downscale(img[:-1], 16, 12)


def test_ngp_to_nerf_matrix_inverts_the_loader():
    """The port's copy of the fixture script's pose conversion writes the
    fixture's own transform matrices, and the loader's conversion undoes it
    at any scale and offset."""
    import json

    gt = np.load(os.path.join(FIXTURE, "poses_ngp.npy"))
    frames = []
    for split in ("train", "val", "test"):
        with open(os.path.join(FIXTURE, f"transforms_{split}.json")) as f:
            frames += json.load(f)["frames"]
    for pose, fr in zip(gt, frames):
        np.testing.assert_allclose(ngp_to_nerf_matrix(pose, scale=1.0),
                                   fr["transform_matrix"], atol=1e-6)
        for scale, offset in ((0.33, (0, 0, 0)), (0.8, (0.1, -0.2, 0.3))):
            back = nerf_matrix_to_ngp(ngp_to_nerf_matrix(pose, scale, offset),
                                      scale, offset)
            np.testing.assert_allclose(back, pose, atol=1e-6)


@pytest.mark.parametrize("split,downscale", [("trainval", 1), ("test", 2)])
def test_load_matches_jax_and_without_cv2(monkeypatch, split, downscale):
    kw = dict(split=split, scale=1.0, downscale=downscale)
    ref = JDataset.load(FIXTURE, **kw)
    got = NeRFDataset.load(FIXTURE, **kw)
    assert (got.h, got.w, len(got)) == (ref.h, ref.w, len(ref))
    np.testing.assert_allclose(got.poses, ref.poses, atol=1e-6)
    np.testing.assert_array_equal(got.intrinsics, ref.intrinsics)
    np.testing.assert_array_equal(got.images, ref.images)
    assert got.radius == pytest.approx(ref.radius, rel=1e-6)
    gt = np.load(os.path.join(FIXTURE, "poses_ngp.npy"))
    first = 0 if split == "trainval" else 5
    np.testing.assert_allclose(got.poses, gt[first:first + len(got)],
                               atol=1e-5)

    monkeypatch.setattr(tprov, "cv2", None)
    bare = NeRFDataset.load(FIXTURE, **kw)
    np.testing.assert_array_equal(bare.poses, got.poses)
    assert bare.images.shape == got.images.shape
    # the same pixels; a downscale within one level of INTER_AREA's
    assert np.abs(bare.images.astype(int) - got.images).max() <= (
        0 if downscale == 1 else 1)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_unreadable_frame_raises(tmp_path, monkeypatch, with_cv2):
    root = str(tmp_path / "scene")
    shutil.copytree(FIXTURE, root)
    if not with_cv2:
        monkeypatch.setattr(tprov, "cv2", None)
    with open(os.path.join(root, "r_train_2.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n broken")
    with pytest.raises(ImageReadError, match="r_train_2"):
        NeRFDataset.load(root, split="train", scale=1.0)
    os.remove(os.path.join(root, "r_train_2.png"))
    with pytest.raises(ImageReadError, match="r_train_2"):
        NeRFDataset.load(root, split="train", scale=1.0)


def test_cli_trains_on_the_fixture_without_cv2(tmp_path, monkeypatch):
    """main_nerf on the Blender tree: 16 steps at 4 levels with cv2 hidden;
    the loss falls, the val view is scored and the test view written."""
    monkeypatch.setattr(tprov, "cv2", None)
    monkeypatch.setattr(main_nerf, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    ws = str(tmp_path / "ws")
    tr = main_nerf.main([FIXTURE, "-O", "--bound", "1.0", "--scale", "1.0",
                         "--dt_gamma", "0", "--min_near", "0.05",
                         "--max_steps", "512", "--iters", "16", "--num_rays",
                         "256", "--log2_hashmap_size", "12", "--device",
                         "cpu", "--workspace", ws])
    assert tr.dataset.images.shape == (5, 64, 64, 3)
    assert np.isfinite(tr.eval_history[-1]["psnr"])
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0], losses
    assert os.path.exists(os.path.join(ws, "results", "ngp_0000_rgb.png"))
