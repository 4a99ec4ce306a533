"""`readback_copy_ms` on a stub trace: the device-to-host copies of every
kind, a traced frame, and nothing where the trace holds no device work."""

from types import SimpleNamespace

import pytest

from frame_bench import run
from frame_bench.trace import Trace

METRIC = run.load_metric("readback_copy_ms")


def _ctx(device, frames=2):
    return SimpleNamespace(trace=Trace(frames, t0=0, t1=10_000_000, device=device))


def test_counts_device_to_host_copies_of_every_kind():
    device = [
        ("Memcpy DtoH (Device -> Pageable)", 0, 3_000_000),
        ("Memcpy DtoH (Device -> Pinned)", 4_000_000, 4_500_000),
        ("Memcpy HtoD (Pinned -> Device)", 5_000_000, 6_000_000),
        ("Memcpy DtoD (Device -> Device)", 6_000_000, 7_000_000),
        ("void fold_kernel<...>", 7_000_000, 9_000_000),
    ]
    assert METRIC.read(_ctx(device)) == pytest.approx(3.5 / 2)


@pytest.mark.parametrize("ctx", [SimpleNamespace(trace=None), _ctx([])])
def test_nothing_to_read(ctx):
    assert METRIC.read(ctx) is None


def test_no_copy_reads_zero():
    assert METRIC.read(_ctx([("void fold_kernel<...>", 0, 1_000)])) == 0.0
