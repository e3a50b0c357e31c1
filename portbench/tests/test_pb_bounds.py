"""The frozen bound arithmetic reproduces PERF.md section 6's bounds at
the recorded shapes, and ``chip_smoke.py``'s functions on the same calls."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from portbench import bounds
from pbtest import REPO


def _k1_call(M, N, n_valid, iters):
    g = torch.Generator().manual_seed(0)
    valid = torch.zeros((M, N), dtype=torch.bool)
    valid[:, :n_valid] = True
    args = dict(T_init=torch.zeros(M, 4, 4), Twl=torch.zeros(M, 4, 4),
                obs=torch.rand(M, N, 2, generator=g), flow_meas=torch.rand(M, N, 2, generator=g),
                depth=torch.rand(M, N, generator=g) + 1.0, valid=valid)
    outs = (torch.zeros(M, 4, 4), torch.zeros(M, N, 2), torch.zeros(M, N),
            torch.zeros(M, N, dtype=torch.bool), torch.zeros(M, dtype=torch.int64),
            torch.zeros(M), torch.full((M,), iters, dtype=torch.int32))
    return args, outs


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1_at_18x4096_is_bound_by_operations_at_the_recorded_figures():
    """PERF.md: 18 x 4096 live object, 1.65 us by operations (bytes 0.749);
    3482 valid points an instance at the recorded 5.50 iterations give the
    1.65."""
    M, N = 18, 4096
    args, outs = _k1_call(M, N, 3482, 0)
    nbytes = bounds.tensor_bytes((*args.values(), *outs))
    us, by = bounds.k1_bound_us(M, N, M * 3482 * 5.5, nbytes)
    assert by == "operations" and us == pytest.approx(1.65, abs=0.005)
    assert nbytes / bounds.H100_BYTES_PER_S * 1e6 == pytest.approx(0.749, abs=0.0005)


def test_k2_at_1x1024_is_bound_by_bytes():
    """PERF.md: 1 x 1024 vs 1024 (TrackLocalMap), 0.167 us by bytes at 1565
    gated pairs."""
    desc = torch.zeros(1024, 256, dtype=torch.int8)
    uv = torch.zeros(1024, 2)
    valid = torch.ones(1024, dtype=torch.bool)
    outs = (torch.zeros(1024), torch.zeros(1024), torch.zeros(1024, dtype=torch.int64))
    nbytes = bounds.tensor_bytes((desc, uv, valid, desc, uv, valid, *outs))
    us, by = bounds.k2_bound_us(1565, nbytes)
    assert by == "bytes" and us == pytest.approx(0.167, abs=0.0005)


@pytest.mark.parametrize("M,N,n_valid,iters", [(1, 2048, 1500, 4), (198, 4096, 3000, 7)])
def test_k1_copy_equals_chip_smoke(M, N, n_valid, iters):
    args, outs = _k1_call(M, N, n_valid, iters)
    want = _chip_smoke().k1_bound_us(args, outs, outs[6])
    nbytes = bounds.tensor_bytes((*args.values(), *outs))
    got = bounds.k1_bound_us(M, N, M * n_valid * iters, nbytes)
    assert got[0] == pytest.approx(want[0], rel=1e-12) and got[1] == want[1]


def test_k2_copy_equals_chip_smoke():
    g = torch.Generator().manual_seed(1)
    desc_a = torch.zeros(3, 1024, 256, dtype=torch.int8)
    uv_a = torch.rand(3, 1024, 2, generator=g) * 600
    va = torch.rand(3, 1024, generator=g) > 0.2
    desc_b = torch.zeros(1024, 256, dtype=torch.int8)
    uv_b = torch.rand(1024, 2, generator=g) * 600
    vb = torch.rand(1024, generator=g) > 0.1
    outs = (torch.zeros(3, 1024), torch.zeros(3, 1024), torch.zeros(3, 1024, dtype=torch.int64))
    args = (desc_a, uv_a, va, desc_b, uv_b, vb)
    want = _chip_smoke().k2_bound_us(args, outs, 12.0)
    pairs = bounds.k2_gated_pairs(uv_a, va, uv_b, vb, 12.0)
    got = bounds.k2_bound_us(pairs, bounds.tensor_bytes((*args, *outs)))
    assert pairs == want[2] and got[0] == pytest.approx(want[0], rel=1e-12)
