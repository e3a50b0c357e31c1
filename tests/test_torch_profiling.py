"""The port's ``utils/profiling`` against the JAX package's (CPU).

``StageTimer``'s ``summary()`` and ``report()`` must be equal to the JAX
package's on the same recorded times (the same arithmetic on Python
floats); a stage records one time per ``with``; a CPU trace written by
``trace`` must hold the name given to ``annotate``.
"""

import json

import jax.numpy as jnp
import numpy as np
import torch

from multimot_track_tpu.utils import profiling as jprof
from multimot_track_tpu_torch.utils import profiling as tprof

TIMES = {"features": [0.0123, 0.0131, 0.0099, 0.0402], "solve": [0.25, 0.125, 0.5],
         "record": [1e-5]}


def test_stage_timer_summary_and_report_equal_jax():
    jt, tt = jprof.StageTimer(), tprof.StageTimer()
    for k, v in TIMES.items():
        jt.times[k] = list(v)
        tt.times[k] = list(v)
    assert tt.summary() == jt.summary()
    assert tt.report() == jt.report()


def test_stage_timer_records_each_stage():
    jt, tt = jprof.StageTimer(), tprof.StageTimer()
    for _ in range(3):
        with tt.stage("a") as h:
            h["result"] = torch.ones(4) * 2
        with jt.stage("a") as h:
            h["result"] = jnp.ones(4) * 2
    with tt.stage("b", result=(torch.zeros(2), {"x": [torch.ones(1)]})):
        pass
    assert sorted(tt.summary()) == ["a", "b"]
    assert tt.summary()["a"]["n"] == jt.summary()["a"]["n"] == 3
    assert all(np.isfinite(v) and v >= 0 for v in tt.times["a"])
    assert tt.report().splitlines()[0].startswith("a" + " " * 29 + " n=   3")


def test_trace_holds_annotated_names(tmp_path):
    with tprof.trace(str(tmp_path), cuda=False) as prof:
        with tprof.annotate("mmt_stage_under_test"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any(e.get("name") == "mmt_stage_under_test" for e in events)
