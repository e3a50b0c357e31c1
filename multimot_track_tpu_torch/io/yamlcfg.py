"""OpenCV-YAML settings parsing (the reference's kitti03.yaml format),
without PyYAML.

The reference reads calibration / ORB / viewer settings through
cv::FileStorage (src/Tracking.cc:142-236).  ``load_opencv_yaml`` reads the
subset those files use: the ``%YAML:1.0`` directive, ``#`` comments,
``---`` / ``...`` document markers and flat top-level ``Key.sub: scalar``
lines, with scalars typed as YAML 1.1 types them (int, float including
``.5`` and ``1.0e-3``, true / false, null, quoted or bare strings).  A key
whose value is a tag (``!!opencv-matrix``), empty (a nested block) or an
unclosed flow collection is skipped together with every line indented
under it or continuing it, so a matrix's ``rows:`` / ``data:`` never reach
the flat keys.  ``config_from_yaml`` is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig, PipelineConfig

# YAML 1.1 scalar forms (the resolver PyYAML's safe loader applies)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" \t"))


def load_opencv_yaml(path) -> dict:
    """Flat ``key -> scalar`` of an OpenCV-YAML file's top-level keys."""
    out = {}
    lines = pathlib.Path(path).read_text().splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        line = _strip_comment(raw).rstrip()
        if not line.strip() or raw.startswith("%") or line.strip() in ("---", "..."):
            continue
        key, sep, val = line.partition(":")
        if not sep or _indent(line) > 0:
            continue               # not a top-level mapping line
        key, val = key.strip().strip("'\""), val.strip()
        depth = val.count("[") + val.count("{") - val.count("]") - val.count("}")
        if val.startswith(("[", "{")) and depth > 0:
            # an unclosed flow collection: consume its continuation lines
            while i < len(lines) and depth > 0:
                more = _strip_comment(lines[i])
                depth += more.count("[") + more.count("{") - more.count("]") - more.count("}")
                i += 1
            continue
        if not val or val.startswith(("!", "&", "*", "|", ">")):
            # a nested block or tagged node (!!opencv-matrix): skip it whole
            while i < len(lines) and (not _strip_comment(lines[i]).strip()
                                      or _indent(lines[i]) > 0):
                i += 1
            continue
        if val.startswith(("[", "{")):
            continue               # a one-line collection: no setting reads one
        out[key] = _scalar(val)
    return out


def config_from_yaml(path, base: PipelineConfig = DEFAULT_CONFIG) -> PipelineConfig:
    d = load_opencv_yaml(path)

    def g(key, default):
        return d.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", base.camera.fx)),
        fy=float(g("Camera.fy", base.camera.fy)),
        cx=float(g("Camera.cx", base.camera.cx)),
        cy=float(g("Camera.cy", base.camera.cy)),
        bf=float(g("Camera.bf", base.camera.bf)),
        width=int(g("Camera.width", base.camera.width)),
        height=int(g("Camera.height", base.camera.height)),
        fps=float(g("Camera.fps", base.camera.fps)),
        depth_map_factor=float(g("DepthMapFactor", base.camera.depth_map_factor)),
        k1=float(g("Camera.k1", base.camera.k1)),
        k2=float(g("Camera.k2", base.camera.k2)),
        p1=float(g("Camera.p1", base.camera.p1)),
        p2=float(g("Camera.p2", base.camera.p2)),
        k3=float(g("Camera.k3", base.camera.k3)),
    )
    fe = dataclasses.replace(
        base.frontend,
        n_features=int(g("ORBextractor.nFeatures", base.frontend.n_features)),
        scale_factor=float(g("ORBextractor.scaleFactor", base.frontend.scale_factor)),
        n_levels=int(g("ORBextractor.nLevels", base.frontend.n_levels)),
        fast_threshold=int(g("ORBextractor.iniThFAST", base.frontend.fast_threshold)),
        fast_min_threshold=int(g("ORBextractor.minThFAST", base.frontend.fast_min_threshold)),
    )
    return dataclasses.replace(base, camera=cam, frontend=fe)
