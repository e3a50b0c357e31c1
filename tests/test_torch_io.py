"""The port's sequence readers against PIL, PyYAML and the JAX package (CPU).

``io/png`` decodes what PIL decodes (files PIL writes, with its adaptive
per-row filters, and files written here with every row on one filter type
0-4) and writes what PIL reads back; its native unfilter equals the numpy
plain version.  ``io/flowio`` is bit for bit the JAX package's;
``io/yamlcfg`` gives the JAX package's config (PyYAML) on OpenCV-YAML files.
The KITTI and TUM readers give FrameData identical field by field
to the JAX package's readers on trees written from the synthetic scenes.
Every input is made here from a numpy seed or a synthetic scene.
"""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from multimot_track_tpu.io import flowio as jflowio
from multimot_track_tpu.io import kitti as jkitti
from multimot_track_tpu.io import tum as jtum
from multimot_track_tpu.io import yamlcfg as jyaml
from multimot_track_tpu_torch.io import flowio as tflowio
from multimot_track_tpu_torch.io import kitti as tkitti
from multimot_track_tpu_torch.io import png
from multimot_track_tpu_torch.io import tum as ttum
from multimot_track_tpu_torch.io import yamlcfg as tyaml
from multimot_track_tpu_torch.io.synth import (
    SYNTH_CAM, make_multimover_frames, write_kitti_tree, write_tum_tree)

RNG = np.random.default_rng(23)


def smooth_image(shape, dtype=np.uint8, blur=3, seed=0):
    """Smoothed noise: neighbouring bytes correlate, so PIL's adaptive
    filter choice spreads over the filter types."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    a = rng.uniform(0, top, shape)
    k = np.ones(blur) / blur
    for ax in (0, 1):
        a = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, a)
    return np.clip(np.round(a), 0, top).astype(dtype)


def filter_types(path):
    """Filter type of every row of a PNG file."""
    data = open(path, "rb").read()
    w, h, depth, ctype = png._ihdr(data[16:29], path)
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rb = w * png._CHANNELS[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, rb + 1)[:, 0].tolist())


# (PIL mode, shape, dtype)
PIL_CASES = [
    ("L", (37, 53), np.uint8), ("L", (16, 64), np.uint8),
    ("RGB", (29, 41), np.uint8), ("RGB", (48, 96), np.uint8),
    ("RGBA", (23, 37), np.uint8),
    ("I;16", (31, 45), np.uint16), ("I;16", (20, 64), np.uint16),
]


@pytest.mark.parametrize("mode,shape,dtype", PIL_CASES)
def test_read_png_matches_pil(tmp_path, mode, shape, dtype):
    ch = {"L": (), "RGB": (3,), "RGBA": (4,), "I;16": ()}[mode]
    a = smooth_image(shape + ch, dtype, seed=len(shape) + shape[1])
    path = tmp_path / "pil.png"
    Image.fromarray(a).save(path)
    ref = np.asarray(Image.open(path))
    out = png.read_png(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert png.read_header(path)[:2] == (shape[1], shape[0])


def test_pil_files_use_several_filters(tmp_path):
    """PIL's adaptive filtering reaches Sub / Up / Average / Paeth, so the
    PIL cases above mix filter types within one image."""
    seen = set()
    for mode, shape, dtype in PIL_CASES:
        ch = {"L": (), "RGB": (3,), "RGBA": (4,), "I;16": ()}[mode]
        Image.fromarray(smooth_image(shape + ch, dtype)).save(tmp_path / "f.png")
        seen |= filter_types(tmp_path / "f.png")
    assert seen & {3, 4} and len(seen) >= 3, seen


def forward_filter(px: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """PNG filter ``ftype`` on every row of (H, row_bytes) uint8 samples;
    returns (H, 1 + row_bytes) with the type byte first."""
    x = px.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = ((x - pred) & 255).astype(np.uint8)
    return np.concatenate([np.full((px.shape[0], 1), ftype, np.uint8), out], axis=1)


def write_filtered(path, arr: np.ndarray, ftype):
    """``arr`` as a PNG with filter type ``ftype`` on every row, or with
    ``ftype[y]`` on row y when it is a list."""
    depth = 16 if arr.dtype == np.uint16 else 8
    ctype = 0 if arr.ndim == 2 else {3: 2, 4: 6, 2: 4}[arr.shape[2]]   # 4: gray + alpha
    samples = arr.astype(">u2") if depth == 16 else arr
    h, w = arr.shape[:2]
    px = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    bpp = px.shape[1] // w
    if isinstance(ftype, int):
        raw = forward_filter(px, ftype, bpp)
    else:
        by_type = {f: forward_filter(px, f, bpp) for f in set(ftype)}
        raw = np.stack([by_type[f][y] for y, f in enumerate(ftype)])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_read_png_each_filter_type(tmp_path, ftype, kind):
    """One filter type on every row, or ("mixed") all five in one image,
    each row predicting from a row written under another type."""
    shape, dtype = {"gray8": ((19, 33), np.uint8), "rgb8": ((17, 29, 3), np.uint8),
                    "rgba8": ((13, 21, 4), np.uint8),
                    "gray16": ((15, 27), np.uint16)}[kind]
    a = smooth_image(shape, dtype, seed=5 if ftype == "mixed" else ftype)
    path = tmp_path / "f.png"
    if ftype == "mixed":
        ftype = [4, 3, 2, 1, 0] + RNG.integers(0, 5, shape[0] - 5).tolist()
    write_filtered(path, a, ftype)
    assert filter_types(path) == (set(ftype) if isinstance(ftype, list) else {ftype})
    np.testing.assert_array_equal(png.read_png(path), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_native_unfilter_matches_plain(bpp):
    rows = RNG.integers(0, 256, (40, 1 + 12 * bpp), dtype=np.uint8)
    rows[:, 0] = RNG.integers(0, 5, 40)
    rows[:5, 0] = [0, 1, 2, 3, 4]
    ref = png.unfilter_plain(rows, bpp)
    np.testing.assert_array_equal(png.unfilter_native(rows, bpp), ref)
    rows[:, 0] %= 3                         # None, Sub and Up alone
    np.testing.assert_array_equal(png.unfilter_native(rows, bpp), png.unfilter_plain(rows, bpp))



def test_unfilter_rejects_unknown_type():
    rows = np.zeros((3, 5), np.uint8)
    rows[1, 0] = 7
    with pytest.raises(ValueError, match="filter type 7 in row 1"):
        png.unfilter_native(rows, 1)
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter_plain(rows, 1)


@pytest.mark.parametrize("kind", ["palette", "interlaced", "rgb16", "gray_alpha"])
def test_read_png_refuses_what_it_does_not_take(tmp_path, kind):
    path = tmp_path / "x.png"
    if kind == "palette":
        Image.fromarray(smooth_image((8, 8, 3))).convert("P").save(path)
    elif kind == "interlaced":
        Image.fromarray(smooth_image((8, 8, 3))).save(path, interlace=1)
        data = bytearray(open(path, "rb").read())
        if data[28] == 0:       # PIL wrote it plain: set the flag, fix the CRC
            data[28] = 1
            data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
            open(path, "wb").write(bytes(data))
    elif kind == "gray_alpha":
        write_filtered(path, smooth_image((6, 5, 2)), 0)
        np.testing.assert_array_equal(np.asarray(Image.open(path))[..., 0],
                                      smooth_image((6, 5, 2))[..., 0])
    else:
        write_filtered(path, smooth_image((6, 5), np.uint16), 0)
        data = bytearray(open(path, "rb").read())
        data[25] = 2            # colour type RGB at 16 bits
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(path)


@pytest.mark.parametrize("shape,dtype", [((37, 53), np.uint8), ((29, 41, 3), np.uint8),
                                         ((16, 64, 3), np.uint8), ((31, 45), np.uint16)])
def test_write_png_read_back_by_pil(tmp_path, shape, dtype):
    a = smooth_image(shape, dtype, seed=5)
    png.write_png(tmp_path / "w.png", a)
    ref = np.asarray(Image.open(tmp_path / "w.png"))
    assert ref.dtype == a.dtype
    np.testing.assert_array_equal(ref, a)
    np.testing.assert_array_equal(png.read_png(tmp_path / "w.png"), a)


@pytest.mark.parametrize("arr", [np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8)])
def test_write_png_refuses_other_types(tmp_path, arr):
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "x.png", arr)


def test_flo_io_bit_identical_to_jax(tmp_path):
    flow = RNG.normal(0, 7, (13, 21, 2)).astype(np.float32)
    flow[0, 0] = [2e9, -3e9]                      # "unknown" flow
    tflowio.write_flo(tmp_path / "t.flo", flow)
    jflowio.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    for p in ("t.flo", "j.flo"):
        a, b = tflowio.read_flo(tmp_path / p), jflowio.read_flo(tmp_path / p)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, flow)
    np.testing.assert_array_equal(tflowio.flow_to_color(flow), jflowio.flow_to_color(flow))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="magic"):
        tflowio.read_flo(tmp_path / "bad.flo")


YAML_HEAD = "%YAML:1.0\n---\n# Camera calibration and distortion parameters (OpenCV)\n"
YAML_KEYS = """Camera.fx: 718.856
Camera.fy: 718.856   # focal length
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: -1.5e-3
Camera.p1: .5
Camera.p2: 0.0
Camera.k3: 1.0e-4
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 40
DepthMapFactor: 256.0
ORBextractor.nFeatures: 2500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.6
"""
YAML_MATRIX = """Tr: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [ 1., 0., 0., 0.,
       0., 1., 0., 0., 0., 0., 1., 0. ]
LEFT.K: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
"""
YAML_FILES = {
    "flat": YAML_HEAD + YAML_KEYS,
    "matrix_first": YAML_HEAD + YAML_MATRIX + YAML_KEYS,
    "matrix_between": (YAML_HEAD + YAML_KEYS.replace("Camera.bf:", YAML_MATRIX + "Camera.bf:")
                       + 'Viewer.Name: "kitti #3"\nSystem.Mode: \'rgbd\'\nViewer.On: true\n'),
    "partial": "%YAML:1.0\nCamera.fx: 500\nCamera.width: 640.0\n# ORBextractor.nLevels: 4\n",
}


@pytest.mark.parametrize("name", sorted(YAML_FILES))
def test_config_from_yaml_matches_jax(tmp_path, name):
    """PyYAML's safe loader refuses the ``!!opencv-matrix`` tag, so the JAX
    package reads the same file without its matrix blocks; the port skips
    them."""
    from multimot_track_tpu import config as jconfig
    from multimot_track_tpu_torch import config as tconfig

    path, plain = tmp_path / f"{name}.yaml", tmp_path / f"{name}.plain.yaml"
    path.write_text(YAML_FILES[name])
    plain.write_text(YAML_FILES[name].replace(YAML_MATRIX, ""))
    if YAML_MATRIX in YAML_FILES[name]:
        with pytest.raises(Exception, match="opencv-matrix"):
            jyaml.load_opencv_yaml(path)
    ct = tyaml.config_from_yaml(path, tconfig.DEFAULT_CONFIG)
    cj = jyaml.config_from_yaml(plain, jconfig.DEFAULT_CONFIG)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct != tconfig.DEFAULT_CONFIG
    # every flat scalar PyYAML reads, with its type
    dj = jyaml.load_opencv_yaml(plain)
    dt = tyaml.load_opencv_yaml(path)
    assert dt == dj
    assert [type(v) for v in dt.values()] == [type(v) for v in dj.values()]
    assert not {"rows", "cols", "dt", "data"} & set(dt)


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


OBJECT_POSE = ("0 1 100 80 180 140 1.5 0.2 11.0 0.1\n"
               "0 2 300 90 350 130 -2.0 0.3 18.0 -0.4\n"
               "2 1 104 80 186 141 1.6 0.2 11.4 0.12\n")


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    frames = make_multimover_frames(n_frames=4)
    root = write_kitti_tree(tmp_path_factory.mktemp("kitti"), frames)
    (root / "object_pose.txt").write_text(OBJECT_POSE)
    return root, frames


def test_kitti_sequence_matches_jax(kitti_tree):
    root, frames = kitti_tree
    t = tkitti.KittiSequence(root, device="cpu")
    j = jkitti.KittiSequence(root)
    assert len(t) == len(j) == 4
    for i in range(4):
        ft, fj = t.load_frame(i), j.load_frame(i)
        _fields_equal(ft, fj)
        np.testing.assert_array_equal(ft.flow, frames[i].flow)
        sem = frames[i].sem_mask             # labels from max_label (4) on read as 0
        np.testing.assert_array_equal(ft.sem_mask, np.where(sem < 4, sem, 0))
    assert t.n_flow_estimated == j.n_flow_estimated == 0
    assert len(t.load_frame(0).obj_ids_gt) == 2


def test_readers_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkitti.KittiSequence(".")


def test_tum_sequence_matches_jax(tmp_path):
    frames = make_multimover_frames(n_frames=3)
    root = write_tum_tree(tmp_path / "rgbd_dataset_freiburg2_synth", frames,
                          bf=SYNTH_CAM["bf"])
    t = ttum.TumRGBDSequence(root, estimate_flow=False, device="cpu")
    j = jtum.TumRGBDSequence(root, estimate_flow=False)
    assert len(t) == len(j) == 3
    assert dataclasses.asdict(t.camera_config()) == dataclasses.asdict(j.camera_config())
    assert t.camera_config().width == SYNTH_CAM["width"] and t.camera_config().fx == 520.9
    for i in range(3):
        ft, fj = t.load_frame(i), j.load_frame(i)
        _fields_equal(ft, fj)
        np.testing.assert_allclose(ft.pose_gt, frames[i].pose_gt, atol=1e-6)
