"""The reader of the program's admission spans: ``prefill_idle_share``
from the ``prefill`` spans on the profiler's timeline and the kernels under
them.  On the CPU the tiny cell's traced run leaves it out, as it does the
other device readers."""
import tiny_cell
from benchkit import devtrace
from benchkit.spec import Bench


def _reader(name):
    return Bench(tiny_cell.REPO).reader(name)


def test_traced_cpu_run_leaves_the_device_share_out(tmp_path):
    r = tiny_cell.run(tmp_path, kind="backlog", trace=True)
    assert r["correct"], r["checks"]
    assert "prefill_idle_share" not in r["metrics"]


def test_reader_on_a_made_trace():
    """Two prefills of 10 and 30 µs; kernels cover 4 µs of the first (two
    overlapping ones) and 6 µs of the second, one kernel outside both."""
    trace = devtrace.DeviceTrace(
        t0=0.0, t1=100.0,
        kernels=[("k", 2.0, 5.0), ("k", 4.0, 6.0), ("k", 40.0, 46.0), ("k", 80.0, 90.0)],
        spans=[("tick", 0.0, 100.0), ("prefill", 0.0, 10.0), ("prefill", 30.0, 60.0),
               ("decode", 60.0, 95.0)])
    run = type("Run", (), {"trace": trace})()
    assert abs(_reader("prefill_idle_share")(run) - 100.0 * 30 / 40) < 1e-9
    run.trace = devtrace.DeviceTrace(0.0, 100.0, [], trace.spans)
    assert _reader("prefill_idle_share")(run) is None
    run.trace = None
    assert _reader("prefill_idle_share")(run) is None
