"""The behaviour gates' shared scenes and the JAX package's recorded values
(``tools/behaviour_ref.py``, ``tools/behaviour_ref.json``) for the port's
gate tests; ``chip_smoke.py`` phase 16 reads the same two files."""

from __future__ import annotations

import importlib.util
import pathlib

_PATH = pathlib.Path(__file__).resolve().parent.parent / "tools" / "behaviour_ref.py"
_spec = importlib.util.spec_from_file_location("behaviour_ref", _PATH)
br = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(br)

MEDIAN_TOL, CAM_RPE_TOL = 1e-3, 1e-5     # the record table against the JAX package's


def run_multimover(k_obj):
    """``test_multimover._run(k_obj)`` on the port, its own draws."""
    from multimot_track_tpu_torch import config as tconfig
    from multimot_track_tpu_torch.io import synth
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    s = MultiMotSystem(br.multimover_config(tconfig, synth.synth_camera_config(), k_obj),
                       enable_keyframes=False, device="cpu")
    for fd in synth.make_multimover_frames(n_frames=br.MULTIMOVER_N):
        s.track_rgbd(fd)
    s.flush()
    return s


def by_label(system):
    out = {}
    for r in system.map.obj_records:
        if r.has_gt:
            out.setdefault(r.sem_label, []).append(r)
    return out


def assert_table_matches(table, ref):
    """Labels, frames and track IDs exactly; each label's median t-RPE
    within MEDIAN_TOL and the camera's mean t-RPE within CAM_RPE_TOL."""
    got = {k: (v["frames"], v["track_ids"]) for k, v in table["labels"].items()}
    assert got == {k: (v["frames"], v["track_ids"]) for k, v in ref["labels"].items()}
    for k, v in ref["labels"].items():
        d = abs(table["labels"][k]["median_t_rpe"] - v["median_t_rpe"])
        assert d <= MEDIAN_TOL, (k, table["labels"][k]["median_t_rpe"], v["median_t_rpe"])
    assert abs(table["cam_t_rpe_rel_mean"] - ref["cam_t_rpe_rel_mean"]) <= CAM_RPE_TOL, \
        (table["cam_t_rpe_rel_mean"], ref["cam_t_rpe_rel_mean"])
