"""The port's native KITTI loader (``native/loader.cc`` through
``io/native_loader.py``) on the CPU.

Its inflate is held to ``zlib.decompress`` exactly (every block type, the
code-length edge cases, random data), its PNG decode to ``io/png.read_png``
exactly (each of the five row filters, every format the port reads), and
``NativeKittiSequence`` to the port's ``KittiSequence`` and to the JAX
package's ``NativeKittiSequence`` on the same tree: depth, flow, mask and
ground truth exactly, gray within ``GRAY_TOL`` (both sides round the same
float32 products; the largest difference seen is one float32 ulp at 255,
1.5e-5).  Every threaded test bounds its own wait, so a deadlock fails the
test instead of hanging the run.
"""

import pathlib
import re
import shutil
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch import cli, kernels
from multimot_track_tpu_torch.io import kitti, native_loader, png
from multimot_track_tpu_torch.io.flowio import write_flo
from multimot_track_tpu_torch.io.synth import make_multimover_frames, write_kitti_tree

torch.set_num_threads(1)

GRAY_TOL = 1e-4
WAIT_S = 60                     # the longest any threaded test may wait


def run_bounded(fn, timeout=WAIT_S):
    """``fn()`` on a daemon thread, joined with a timeout: a deadlock fails."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:          # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no answer within {timeout} s: deadlock"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ------------------------------------------------------------------ inflate

def _data(kind, rng):
    if kind == "random":
        return rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    if kind == "skewed":        # few symbols: long Huffman codes, many matches
        return rng.choice(8, 90_000, p=[.6, .2, .1, .05, .02, .015, .01, .005]).astype(
            np.uint8).tobytes()
    if kind == "runs":          # the longest matches, distances across 32 KiB
        block = rng.integers(0, 256, 33_000, dtype=np.uint8).tobytes()
        return b"\0" * 5000 + block + block[:20_000] + b"x" * 1000 + block
    if kind == "text":
        words = [b"flow", b"depth", b"mask", b"pose", b"frame", b"\n"]
        return b" ".join(words[i] for i in rng.integers(0, len(words), 20_000))
    return b""


@pytest.mark.parametrize("kind", ["random", "skewed", "runs", "text", "empty"])
@pytest.mark.parametrize("level,strategy", [
    (0, zlib.Z_DEFAULT_STRATEGY),       # stored blocks
    (1, zlib.Z_DEFAULT_STRATEGY),
    (9, zlib.Z_DEFAULT_STRATEGY),
    (6, zlib.Z_FIXED),                  # fixed-Huffman blocks only
    (6, zlib.Z_HUFFMAN_ONLY),           # literals only
    (6, zlib.Z_RLE),                    # distance 1 only
])
def test_inflate_equals_zlib(kind, level, strategy):
    data = _data(kind, np.random.default_rng(len(kind) + level + 10 * strategy))
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    z = c.compress(data) + c.flush()
    assert native_loader.inflate(z, len(data)) == zlib.decompress(z) == data


def test_inflate_many_blocks_and_flushes():
    """Blocks of every type in one stream (zlib stores the random part,
    codes short flushed parts with the fixed code and the rest with dynamic
    codes), with back-references across block boundaries (full flushes
    reset the window, sync flushes do not)."""
    rng = np.random.default_rng(3)
    parts = [_data(k, rng) for k in ("text", "runs", "skewed", "random")]
    parts += [b"frame 1", b"frame 2", _data("text", rng)[:5000]]
    c = zlib.compressobj(9)
    z = b""
    for i, p in enumerate(parts):
        z += c.compress(p) + c.flush(zlib.Z_SYNC_FLUSH if i % 2 else zlib.Z_FULL_FLUSH)
    z += c.flush()
    assert native_loader.inflate(z, sum(map(len, parts))) == zlib.decompress(z)


class BitWriter:
    """Deflate's bit order: values from their low bit, Huffman codes from
    their high bit."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> i) & 1 for i in range(n)]

    def code(self, code, n):
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(sum(b[i + j] << j for j in range(8)) for i in range(0, len(b), 8))


def canonical(lengths):
    """Canonical Huffman codes of ``lengths`` (RFC 1951, 3.2.2)."""
    count = np.bincount([n for n in lengths if n], minlength=16)
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    out = {}
    for s, n in enumerate(lengths):
        if n:
            out[s] = (nxt[n], n)
            nxt[n] += 1
    return out


ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


def dynamic_stream(lit_len, dist_len, symbols, cl_len):
    """A zlib stream of one final dynamic block whose code lengths are
    written with the repeat codes 16 / 17 / 18 wherever they apply.
    ``symbols``: literals (int) and (length, distance) matches, both
    given as (symbol, extra bits, extra value) triples already."""
    lengths = list(lit_len) + list(dist_len)
    ops, i = [], 0                                        # run-length encode
    while i < len(lengths):
        n = lengths[i]
        run = 1
        while i + run < len(lengths) and lengths[i + run] == n:
            run += 1
        if n == 0 and run >= 11:
            r = min(run, 138)
            ops.append((18, 7, r - 11))
        elif n == 0 and run >= 3:
            r = min(run, 10)
            ops.append((17, 3, r - 3))
        elif n and i and lengths[i - 1] == n and run >= 3:
            r = min(run, 6)
            ops.append((16, 2, r - 3))
        else:
            r = 1
            ops.append((n, 0, 0))
        i += r
    cl_codes = canonical(cl_len)
    w = BitWriter()
    w.put(1, 1)
    w.put(2, 2)
    w.put(len(lit_len) - 257, 5)
    w.put(len(dist_len) - 1, 5)
    w.put(19 - 4, 4)
    for s in ORDER:
        w.put(cl_len[s], 3)
    for sym, nb, val in ops:
        w.code(*cl_codes[sym])
        w.put(val, nb)
    lit, dist = canonical(lit_len), canonical(dist_len)
    out = bytearray()
    for item in symbols:
        if isinstance(item, int):
            w.code(*lit[item])
            if item < 256:
                out.append(item)
        else:
            (ls, lb, lv, length), (ds, db, dv, d) = item
            w.code(*lit[ls])
            w.put(lv, lb)
            w.code(*dist[ds])
            w.put(dv, db)
            for _ in range(length):
                out.append(out[-d])
    return b"\x78\x01" + w.bytes() + struct.pack(">I", zlib.adler32(bytes(out))), bytes(out)


# the code-length code: 13 symbols of 4 bits and 6 of 5 (complete)
CL_LEN = [5 if s in (1, 2, 11, 12, 13, 14) else 4 for s in range(19)]


def test_inflate_dynamic_code_length_edge_cases():
    """A dynamic block with a single distance code of length 1 (incomplete,
    which deflate allows), runs of zero lengths (codes 17 and 18), repeats
    of the previous length (16), and literal codes up to 15 bits long."""
    lens = [0] * 286
    for c in "bcdefgh":
        lens[ord(c)] = 3                                      # 7/8 of the code space
    chain = [ord(c) for c in "ij"] + [256, 264] + [ord(c) for c in "klmnoprs"]
    for n, sym in enumerate(chain, start=4):                  # 1/16 + ... + 1/2^15
        lens[sym] = n
    lens[ord("t")] = 15                                       # the last 1/2^15
    assert sum(2.0 ** -n for n in lens if n) == 1.0
    syms = [ord(c) for c in "bcdefghijklmnoprst"] + [ord("s")]
    syms += [((264, 0, 0, 10), (0, 0, 0, 1))] * 3 + [ord("t"), 256]  # length 10, distance 1
    z, expect = dynamic_stream(lens, [1], syms, CL_LEN)
    assert zlib.decompress(z) == expect
    assert native_loader.inflate(z, len(expect)) == expect


@pytest.mark.parametrize("damage", ["adler", "truncated", "block type 3", "stored length",
                                    "header"])
def test_inflate_rejects_a_damaged_stream(damage):
    data = _data("text", np.random.default_rng(5))
    z = bytearray(zlib.compress(data, 6))
    if damage == "adler":
        z[-1] ^= 1
    elif damage == "truncated":
        z = z[:len(z) // 2]
    elif damage == "block type 3":
        z = bytearray(b"\x78\x01\x07\x00\x00\x00\x00")
    elif damage == "stored length":
        z = bytearray(b"\x78\x01\x01\x05\x00\xfb\xff" + b"hello" + b"\0\0\0\0")
    else:
        z[1] ^= 1
    with pytest.raises(zlib.error):
        zlib.decompress(bytes(z))
    with pytest.raises(IOError):
        native_loader.inflate(bytes(z), len(data))


# ---------------------------------------------------------------------- PNG

def filter_rows(rows: np.ndarray, bpp: int, ftypes) -> np.ndarray:
    """Apply PNG filter ftypes[y] to each row of ``rows`` (H, row_bytes)."""
    H, rb = rows.shape
    x = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, rb), np.int32), x[:-1]])
    left = np.hstack([np.zeros((H, bpp), np.int32), x[:, :-bpp]])
    ul = np.hstack([np.zeros((H, bpp), np.int32), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    pred = {0: 0 * x, 1: left, 2: up, 3: (left + up) >> 1, 4: paeth}
    out = np.empty((H, rb + 1), np.uint8)
    for y in range(H):
        out[y, 0] = ftypes[y]
        out[y, 1:] = (x[y] - pred.get(ftypes[y], 0 * x)[y]) & 255     # > 4: unknown types
    return out


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png_filtered(path, arr, ftypes, depth=8, ctype=None, idat_size=None, level=6,
                       interlace=0):
    """A PNG of ``arr`` with filter ftypes[y] on row y, its IDAT stream cut
    into chunks of ``idat_size`` bytes."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch] if ctype is None else ctype
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr).view(np.uint8)
    raw = filter_rows(rows.reshape(h, -1), max(1, ch * depth // 8), ftypes)
    z = zlib.compress(raw.tobytes(), level)
    step = idat_size or len(z)
    idat = b"".join(_chunk(b"IDAT", z[i:i + step]) for i in range(0, len(z), step))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    pathlib.Path(path).write_bytes(png.SIGNATURE + _chunk(b"IHDR", ihdr) + idat
                                   + _chunk(b"IEND", b""))


def _image(fmt, rng, h=23, w=37):
    if fmt == "gray16":
        return rng.integers(0, 65536, (h, w), dtype=np.uint16), 16
    ch = {"gray8": (), "rgb": (3,), "rgba": (4,)}[fmt]
    # smooth plus noise, so that every predictor has something to predict
    base = (np.add.outer(np.arange(h), np.arange(w)) * 3)[(...,) + (None,) * len(ch)]
    img = (base + rng.integers(0, 40, (h, w) + ch)) % 256
    return img.astype(np.uint8), 8


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("fmt", ["gray8", "gray16", "rgb", "rgba"])
def test_png_filters_and_formats(tmp_path, ftype, fmt):
    rng = np.random.default_rng(7)
    img, depth = _image(fmt, rng)
    ftypes = rng.integers(0, 5, img.shape[0]) if ftype == "mixed" else [ftype] * img.shape[0]
    path = tmp_path / "a.png"
    # 64-byte IDAT chunks: back-references cross chunk boundaries
    write_png_filtered(path, img, ftypes, depth=depth, idat_size=64)
    got = native_loader.read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, png.read_png(path))


@pytest.mark.parametrize("case", ["palette", "gray alpha", "interlaced", "rgb16", "gray1",
                                  "crc", "filter 5", "no IEND", "short data"])
def test_png_rejects_what_io_png_rejects(tmp_path, case):
    rng = np.random.default_rng(8)
    img, _ = _image("gray8", rng)
    path = tmp_path / "a.png"
    if case == "palette":
        write_png_filtered(path, img, [0] * img.shape[0], ctype=3)
    elif case == "gray alpha":
        write_png_filtered(path, np.stack([img, img], -1), [0] * img.shape[0], ctype=4)
    elif case == "interlaced":
        write_png_filtered(path, img, [0] * img.shape[0], interlace=1)
    elif case == "rgb16":
        write_png_filtered(path, np.stack([img.astype(np.uint16)] * 3, -1),
                           [0] * img.shape[0], depth=16)
    elif case == "gray1":
        write_png_filtered(path, img, [0] * img.shape[0], depth=1)
    else:
        write_png_filtered(path, img, [5 if case == "filter 5" else 1] * img.shape[0])
        data = bytearray(path.read_bytes())
        if case == "crc":
            data[40] ^= 0x10                                  # inside the IDAT body
        elif case == "no IEND":
            data = data[:-12]
        elif case == "short data":
            data = png.SIGNATURE + _chunk(b"IHDR", bytes(data[16:29])) + _chunk(
                b"IDAT", zlib.compress(b"\0" * 10)) + _chunk(b"IEND", b"")
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(path)
    with pytest.raises(IOError):
        native_loader.read_png(path)


# --------------------------------------------------------------- sequences

@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory, frames):
    return write_kitti_tree(tmp_path_factory.mktemp("kitti") / "seq", frames)


def tiny_tree(dst, n, rng, h=24, w=40, flow=True, semantic=True):
    """An n-frame KITTI tree of random small images (no rendering)."""
    dst = pathlib.Path(dst)
    for sub in ("image", "depth") + (("flow",) if flow else ()) + (
            ("semantic",) if semantic else ()):
        (dst / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        png.write_png(dst / "image" / f"{i:06d}.png",
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        png.write_png(dst / "depth" / f"{i:06d}.png",
                      rng.integers(0, 65536, (h, w), dtype=np.uint16))
        if flow:
            write_flo(dst / "flow" / f"{i:06d}.flo",
                      rng.normal(0, 3, (h, w, 2)).astype(np.float32))
        if semantic:
            np.savetxt(dst / "semantic" / f"{i:06d}.txt", rng.integers(-1, 7, (h, w)),
                       fmt="%d")
    (dst / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(n)))
    (dst / "pose_gt.txt").write_text("".join(
        f"{i} " + " ".join(f"{x:.6f}" for x in np.eye(4).reshape(-1) + i) + "\n"
        for i in range(n)))
    return dst


def assert_same_frame(a, b, gray_tol=GRAY_TOL):
    """Depth, flow, mask and ground truth exactly; gray within gray_tol.
    Returns the largest gray difference."""
    for f in ("depth_raw", "flow", "sem_mask", "pose_gt", "obj_ids_gt", "obj_poses_gt",
              "obj_bboxes_gt"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.index == b.index and a.timestamp == b.timestamp
    assert a.gray.dtype == b.gray.dtype == np.float32
    d = float(np.abs(a.gray - b.gray).max())
    assert d <= gray_tol, d
    return d


@pytest.mark.parametrize("n_threads,prefetch_depth,cache_cap", [(2, 4, 8), (1, 1, 1),
                                                                (4, 8, 2)])
def test_native_equals_the_ports_kittisequence(tree, n_threads, prefetch_depth, cache_cap):
    py = kitti.KittiSequence(tree, device="cpu")
    nat = native_loader.NativeKittiSequence(tree, n_threads=n_threads,
                                            prefetch_depth=prefetch_depth,
                                            cache_cap=cache_cap, device="cpu")
    try:
        assert len(nat) == len(py) == 3 and (nat.H, nat.W) == py.load_frame(0).gray.shape
        worst = max(run_bounded(lambda: [assert_same_frame(nat.load_frame(i), py.load_frame(i))
                                         for i in (0, 1, 2, 1, 0)]))
        assert worst <= 1.6e-5, worst                         # one float32 ulp at 255
    finally:
        nat.close()


def test_native_equals_the_jax_native_loader(tree):
    """The JAX package's loader (libpng) on the same tree, held as its own
    test holds it against its Python reader, with gray within GRAY_TOL."""
    jnl = pytest.importorskip("multimot_track_tpu.io.native_loader")
    if not jnl.build_native():
        pytest.skip("the JAX package's loader does not build (no libpng)")
    j = jnl.NativeKittiSequence(tree)
    nat = native_loader.NativeKittiSequence(tree, device="cpu")
    try:
        for i in range(3):
            a, b = run_bounded(lambda: (nat.load_frame(i), j.load_frame(i)))
            assert_same_frame(a, b, gray_tol=GRAY_TOL)
    finally:
        nat.close()
        j.close()


def test_missing_flow_is_estimated_and_the_last_frame_is_zero(tmp_path, frames):
    """As the JAX package's test_native_estimates_missing_flow: LK flow from
    the native gray against the Python reader's (the two grays differ by an
    ulp, which flips ambiguous block matches on a few pixels)."""
    root = write_kitti_tree(tmp_path / "noflo", frames, flow=False)
    nat = native_loader.get_sequence(root, device="cpu")
    py = kitti.KittiSequence(root, device="cpu")
    try:
        fd = run_bounded(lambda: nat.load_frame(0))
        assert np.abs(fd.flow).max() > 1.0, "flow was not estimated"
        ref = py.load_frame(0)
        d = np.abs(fd.flow - ref.flow).max(axis=-1)
        assert (d < 0.1).mean() > 0.99, (d < 0.1).mean()
        assert nat.n_flow_estimated == py.n_flow_estimated == 1
        assert np.abs(run_bounded(lambda: nat.load_frame(2)).flow).max() == 0.0
        nat.estimate_flow = False                              # the CLI's --no-estimate-flow
        assert np.abs(run_bounded(lambda: nat.load_frame(0)).flow).max() == 0.0
    finally:
        nat.close()


def test_missing_semantic_gives_zero_masks(tmp_path):
    root = tiny_tree(tmp_path / "nosem", 3, np.random.default_rng(1), semantic=False)
    nat = native_loader.NativeKittiSequence(root, device="cpu")
    py = kitti.KittiSequence(root, device="cpu")
    try:
        for i in range(3):
            a = run_bounded(lambda: nat.load_frame(i))
            assert_same_frame(a, py.load_frame(i))
            assert not a.sem_mask.any()
    finally:
        nat.close()


def test_mask_clamp_and_max_label(tmp_path):
    root = tiny_tree(tmp_path / "t", 2, np.random.default_rng(2))
    for max_label in (4, 6):
        nat = native_loader.NativeKittiSequence(root, max_label=max_label, device="cpu")
        py = kitti.KittiSequence(root, max_label=max_label, device="cpu")
        try:
            a = run_bounded(lambda: nat.load_frame(1))
            assert_same_frame(a, py.load_frame(1))
            assert a.sem_mask.max() == max_label - 1 and a.sem_mask.min() == 0
        finally:
            nat.close()


def test_corrupt_crc_raises(tmp_path):
    root = tiny_tree(tmp_path / "crc", 3, np.random.default_rng(4))
    p = root / "image" / "000001.png"
    data = bytearray(p.read_bytes())
    data[45] ^= 0x01
    p.write_bytes(bytes(data))
    nat = native_loader.NativeKittiSequence(root, device="cpu")
    try:
        with pytest.raises(IOError, match="CRC mismatch"):
            run_bounded(lambda: nat.load_frame(1))
        run_bounded(lambda: nat.load_frame(2))                # the others still load
    finally:
        nat.close()
    # frame 0 bad: no reader at all, and no fallback to the Python one
    shutil.copy(p, root / "image" / "000000.png")
    with pytest.raises(IOError, match="CRC mismatch"):
        native_loader.get_sequence(root, device="cpu")


@pytest.mark.parametrize("bad", ["short mask", "float mask", "flo magic"])
def test_a_bad_frame_file_raises(tmp_path, bad):
    root = tiny_tree(tmp_path / "bad", 2, np.random.default_rng(6))
    if bad == "short mask":
        (root / "semantic" / "000001.txt").write_text("1 2 3\n")
    elif bad == "float mask":
        (root / "semantic" / "000001.txt").write_text("1.5 " * (24 * 40))
    else:
        (root / "flow" / "000001.flo").write_bytes(b"\0" * 12)
    nat = native_loader.NativeKittiSequence(root, device="cpu")
    try:
        with pytest.raises(IOError):
            run_bounded(lambda: nat.load_frame(1))
    finally:
        nat.close()


def test_a_small_cache_with_a_deep_prefetch_never_loses_a_waiter(tmp_path):
    """cache_cap=1 with prefetch_depth=8 over every frame, forwards, backwards
    and from three consumers at once: each frame a consumer waits for stays
    cached until it is copied out."""
    n = 16
    root = tiny_tree(tmp_path / "evict", n, np.random.default_rng(9))
    py = kitti.KittiSequence(root, device="cpu")
    ref = [py.load_frame(i) for i in range(n)]
    nat = native_loader.NativeKittiSequence(root, n_threads=4, prefetch_depth=8, cache_cap=1,
                                            device="cpu")
    try:
        def sweep(order):
            for i in order:
                assert_same_frame(nat.load_frame(i), ref[i])
            return True

        for _ in range(3):
            run_bounded(lambda: sweep(range(n)))
            run_bounded(lambda: sweep(reversed(range(n))))
        done = []
        consumers = [threading.Thread(target=lambda o=order: done.append(sweep(o)), daemon=True)
                     for order in (range(n), reversed(range(n)), range(0, n, 3), range(n))]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)                # interleave the consumers finely
        try:
            for t in consumers:
                t.start()
            for t in consumers:
                t.join(WAIT_S)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in consumers), "a consumer never got its frame"
        assert len(done) == len(consumers), "a consumer failed"
    finally:
        nat.close()


def test_the_loader_builds_from_the_standard_library_alone(tmp_path):
    """No libpng, no zlib: the source includes standard headers and the
    shared unfilter, and the build links no library."""
    src = kernels.NATIVE / "loader.cc"
    heads = re.findall(r'^\s*#\s*include\s+[<"]([^>"]+)[>"]', src.read_text(), re.M)
    assert "png_unfilter.h" in heads
    assert all(h == "png_unfilter.h" or "." not in h for h in heads), heads
    lib = native_loader.build_native()
    log = (lib.parent / "build.log").read_text().splitlines()[0]
    assert " -l" not in log and "-ffp-contract=off" in log
    # the build hash covers included headers: an edited header rebuilds
    (tmp_path / "a.cc").write_text('#include "b.h"\nint f() { return B; }\n')
    (tmp_path / "b.h").write_text("#define B 1\n")
    first = kernels._source_bytes(tmp_path / "a.cc")
    (tmp_path / "b.h").write_text("#define B 2\n")
    assert kernels._source_bytes(tmp_path / "a.cc") != first
    assert (kernels.NATIVE / "png_unfilter.h").read_bytes() in kernels._source_bytes(src)


@pytest.mark.parametrize("flags", [[], ["--mono"]])
def test_the_cli_reads_kitti_trees_through_the_native_loader(tree, flags):
    args = cli.parse_args([str(tree), "--cpu"] + flags)
    from multimot_track_tpu_torch.config import DEFAULT_CONFIG

    seq, _ = cli.open_sequence(args, DEFAULT_CONFIG, "cpu")
    try:
        assert type(seq) is native_loader.NativeKittiSequence
        assert seq.device.type == "cpu"
    finally:
        seq.close()
