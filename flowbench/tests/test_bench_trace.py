"""The reduction of a profiler trace: busy time as the union of device
intervals, idle gaps named by what the host did, device time per group."""

from types import SimpleNamespace

from flowbench import trace


class Event:
    def __init__(self, kind, name, start_us, dur_us, thread=1):
        self._k, self._n, self._s, self._d, self._t = kind, name, start_us, dur_us, thread

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def start_thread_id(self):
        return self._t


def fake(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_and_idle():
    events = [
        Event("user_annotation", trace.WINDOW, 0, 100),
        Event("user_annotation", "flowbench.train_step", 0, 60),
        Event("cpu_op", "aten::conv2d", 5, 20),
        Event("user_annotation", "flowbench.input", 60, 40),
        Event("cpu_op", "aten::copy_", 70, 20),
        Event("kernel", "void cudnn::conv_kernel", 10, 30),
        Event("kernel", "ncclDevKernel_AllReduce", 30, 20),  # overlaps the conv by 10
        Event("gpu_memcpy", "Memcpy HtoD", 90, 5),
        Event("gpu_user_annotation", "flowbench.train_step", 0, 100),  # not device work
    ]
    t = trace.reduce(fake(events))
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 45e-6) < 1e-12  # [10, 50] and [90, 95]
    assert abs(t.groups["conv"] - 30e-6) < 1e-12 and "copy" in t.groups
    # gaps: [0, 10] under conv2d's span? mid 5 -> aten::conv2d starts at 5
    labels = set(t.idle)
    assert "input:aten::copy_" in labels  # [50, 90] has its middle at 70
    assert abs(sum(t.idle.values()) - 55e-6) < 1e-12
    b = t.breakdown()
    assert b["device_ops"][0][0] == "conv" and len(b["idle_gaps"]) <= 10


def test_a_stretch_without_device_work_reads_nothing():
    assert trace.reduce(fake([Event("user_annotation", trace.WINDOW, 0, 10)])) is None
