"""ctypes binding of the native prefetching KITTI loader (``native/loader.cc``).

Port of ``multimot_track_tpu.io.native_loader``.  ``NativeKittiSequence``
keeps :class:`~multimot_track_tpu_torch.io.kitti.KittiSequence`'s
``load_frame`` -> ``FrameData`` contract, but decodes the PNG, .flo and mask
files of the frames ahead on C++ worker threads.  Every call into the
library goes through ``ctypes``, which releases the GIL, so the Python
consumer runs while the workers decode (the reference reads every file
synchronously on the tracking thread, Examples/RGB-D/rgbd_tum.cc:115-189).

The library carries its own inflate, so it needs no libpng or zlib; it is
built at first use by ``kernels.build_native`` with the host compiler.
Unlike the JAX package's ``get_sequence``, nothing falls back to the
Python reader: a failed build raises ``KernelBuildError``, a frame that does
not decode raises ``IOError``.  A missing ``semantic/`` file gives a zero
mask and a missing ``.flo`` is estimated by LK flow on the reader's device,
as ``KittiSequence`` does.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np

from multimot_track_tpu_torch import kernels
from multimot_track_tpu_torch.io import kitti
from multimot_track_tpu_torch.io.frame import FrameData

_ERR_LEN = 1024


def build_native():
    """Compile ``native/loader.cc`` (once) and return the library's path;
    raises ``KernelBuildError`` when the compiler fails."""
    return kernels.build_native("loader")


@functools.cache
def _lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build_native()))
    vp, i, ll, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p
    dll.mmt_open.restype = vp
    dll.mmt_open.argtypes = [cp, i, i, i, i, cp, i]
    dll.mmt_dims.argtypes = [vp, vp, vp]
    dll.mmt_prefetch.argtypes = [vp, i, i]
    dll.mmt_get.restype = i
    dll.mmt_get.argtypes = [vp, i, vp, vp, vp, vp, cp, i]
    dll.mmt_close.argtypes = [vp]
    dll.mmt_inflate.restype = i
    dll.mmt_inflate.argtypes = [vp, ll, vp, ll, vp, cp, i]
    dll.mmt_png_read.restype = i
    dll.mmt_png_read.argtypes = [cp, vp, vp, ll, cp, i]
    return dll


def _message(buf) -> str:
    return buf.value.decode(errors="replace")


def inflate(data: bytes, size: int) -> bytes:
    """``zlib.decompress(data)`` through the loader's own inflate; ``size``
    bounds the output.  Raises ``IOError`` on a malformed stream."""
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(max(size, 1), np.uint8)
    n, err = ctypes.c_longlong(), ctypes.create_string_buffer(_ERR_LEN)
    if not _lib().mmt_inflate(src.ctypes.data, src.size, dst.ctypes.data, size,
                              ctypes.byref(n), err, _ERR_LEN):
        raise IOError(f"inflate: {_message(err)}")
    return dst[:n.value].tobytes()


def read_png(path) -> np.ndarray:
    """``io/png.read_png`` through the loader's decoder: the same arrays for
    the same files.  Raises ``IOError`` on a file it does not take."""
    dims = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    name = str(path).encode()
    if not _lib().mmt_png_read(name, dims.ctypes.data, None, 0, err, _ERR_LEN):
        raise IOError(_message(err))
    w, h, ch, depth = (int(x) for x in dims)
    out = np.empty(h * w * ch, np.uint16)
    if not _lib().mmt_png_read(name, dims.ctypes.data, out.ctypes.data, out.size, err,
                               _ERR_LEN):
        raise IOError(_message(err))
    out = out.reshape((h, w) if ch == 1 else (h, w, ch))
    return out if depth == 16 else out.astype(np.uint8)


class NativeKittiSequence(kitti.KittiSequence):
    """``KittiSequence`` with native threaded decode and prefetch.

    ``n_threads`` workers decode; each ``load_frame(i)`` queues frames
    i + 1 .. i + ``prefetch_depth``; at most ``cache_cap`` decoded frames
    are kept, besides those a consumer waits for.  ``device``: where a
    missing .flo is estimated.  ``last_wait_s`` is the time the last
    ``load_frame`` waited for the workers."""

    def __init__(self, root, max_label: int = 4, n_threads: int = 2,
                 prefetch_depth: int = 4, cache_cap: int = 8, device="cuda"):
        super().__init__(root, max_label=max_label, device=device)
        self._dll = _lib()
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._dll.mmt_open(str(self.root).encode(), self.n_frames, max_label,
                                     n_threads, cache_cap, err, _ERR_LEN)
        if not self._h:
            raise IOError(f"native loader cannot open {root}: {_message(err)}")
        H, W = ctypes.c_int(), ctypes.c_int()
        self._dll.mmt_dims(self._h, ctypes.byref(H), ctypes.byref(W))
        self.H, self.W = H.value, W.value
        self._prefetch_depth = prefetch_depth
        self.last_wait_s = 0.0

    def _get(self, i: int):
        """Frame i's (gray, depth_raw, flow, sem_mask) from the workers."""
        H, W = self.H, self.W
        gray = np.empty((H, W), np.float32)
        depth = np.empty((H, W), np.float32)
        flow = np.empty((H, W, 2), np.float32)
        sem = np.empty((H, W), np.int32)
        err = ctypes.create_string_buffer(_ERR_LEN)
        t0 = time.perf_counter()
        ok = self._dll.mmt_get(self._h, i, gray.ctypes.data, depth.ctypes.data,
                               flow.ctypes.data, sem.ctypes.data, err, _ERR_LEN)
        self.last_wait_s = time.perf_counter() - t0
        if not ok:
            raise IOError(f"native decode failed for frame {i}: {_message(err)}")
        return gray, depth, flow, sem

    def _load_gray(self, i: int) -> np.ndarray:
        # the next frame for LK flow: decoded (and cached) by the workers
        return self._get(i)[0]

    def load_frame(self, i: int) -> FrameData:
        if self._h is None:
            raise IOError("native loader is closed")
        self._dll.mmt_prefetch(self._h, i + 1, self._prefetch_depth)
        gray, depth, flow, sem = self._get(i)
        # the library zero-fills a missing .flo: estimate it as the Python
        # reader does (a zero flow field kills every correspondence)
        if not self.frame_paths(i)["flow"].exists():
            wait = self.last_wait_s
            flow = self._flow_or_estimate(i, gray)
            self.last_wait_s += wait
        return self.frame_record(i, gray, depth, flow, sem)

    def close(self):
        if getattr(self, "_h", None):
            self._dll.mmt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def get_sequence(root, **kw) -> NativeKittiSequence:
    """The native loader over ``root`` (keywords: ``NativeKittiSequence``'s).
    No fallback: a failed build or decode raises."""
    return NativeKittiSequence(root, **kw)
