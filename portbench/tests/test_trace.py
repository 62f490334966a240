"""The reduction of a traced window: the union of overlapping device
intervals, spans, attribution to ring matmul calls, idle gaps."""
import pytest

from portbench import trace


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union(iv, 0, 100) == [[0, 15], [20, 30], [40, 50]]
    assert trace.covered(iv, 0, 100) == 35
    # clipped to the window
    assert trace.covered(iv, 8, 45) == 7 + 10 + 5
    assert trace.gaps(trace.union(iv, 0, 60), 0, 60) == \
        [(15, 20), (30, 40), (50, 60)]


def _events():
    # host: window [0, 1000); step spans [0, 400) and [500, 1000); a ring
    # matmul call [10, 20) whose launch (cpu event 7) links two kernels
    cpu = [("cpu", "portbench.window", 0, 1000, 1, 0),
           ("cpu", "portbench.step", 0, 400, 2, 0),
           ("cpu", "portbench.step", 500, 1000, 3, 0),
           ("cpu", "portbench.ring_matmul", 10, 20, 4, 0),
           ("cpu", "cudaLaunchKernel", 12, 13, 7, 0),
           ("cpu", "cudaLaunchKernel", 30, 31, 8, 0),
           ("cpu", "cudaLaunchKernel", 600, 601, 9, 0)]
    gpu = [("gpu", "ring_matmul_kernel", 50, 150, 70, 7),
           ("gpu", "elementwise", 100, 200, 80, 8),
           ("gpu", "elementwise", 650, 700, 90, 9)]
    return cpu + gpu


def test_reduce_events():
    s = trace.reduce_events(_events())
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(200e-9)   # [50, 200), [650, 700)
    assert s["device_ops"] == 3 and s["unlinked_device_ops"] == 0
    st = s["phases"]["step"]
    assert st["spans"] == 2 and st["span_s"] == pytest.approx(900e-9)
    assert st["busy_s"] == pytest.approx(200e-9) and st["device_ops"] == 3
    assert st["ring_matmul_device_s"] == pytest.approx(100e-9)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["ring_matmul_kernel"] == pytest.approx(100e-9)
    assert ops["elementwise"] == pytest.approx(150e-9)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # a gap is named by the span the host was in at its start: [0, 50),
    # [200, 650) and [700, 1000) all start inside a step
    assert gaps == {"step": pytest.approx((50 + 450 + 300) * 1e-9)}


def test_span_index_innermost():
    idx = trace.SpanIndex([("window", 0, 100), ("step", 10, 50),
                           ("ring_matmul", 20, 30)])
    assert idx.at(25) == "ring_matmul"
    assert idx.at(40) == "step"
    assert idx.at(60) == "window"
    assert idx.at(200) is None
    assert idx.inside("step", 49) and not idx.inside("step", 50)
