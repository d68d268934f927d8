"""The readers of the port's own spans and counters
(``span_readers.py`` and the metrics that use it), fed a synthetic
recorder: spans inside and outside the window, the profiled frame after
it; None where nothing was recorded or the port has no recorder. Then the
real port on the CPU through the harness, where nothing is captured."""

import types

import pytest

from gpubench import cells, harness, span_readers

FRAMES = ["eager_pass_ms.frames", "capture_ms.frames",
          "capture_allocs.frames", "release_ms.frames",
          "sampler_ms.frames", "intersect_ms.frames", "alive_share.frames"]
TRAIN = ["step_host_ms.train", "step_launch_ms.train"]


def span(sid, name, start, end, request, attrs=None, device_ms=None):
    return {"id": sid, "name": name, "start": start, "end": end,
            "parent": None, "request": request, "attrs": attrs or {},
            "device_ms": device_ms}


class Recorder:
    """What the readers use of the port's ``utils.metrics``."""

    def __init__(self, records, counts=None):
        self.records, self.counts = records, counts or {}

    def spans(self):
        return list(self.records)

    def counters(self, request=None):
        return dict(self.counts.get(request, {}))


def frame(fid, t, eager, capture, release, allocs):
    """A frame at host time t: its root, eager pass, capture and release
    (ms), the capture's allocations and frees."""
    s = 1e-3
    return [span(fid, "crt.frame", t, t + 1.0, fid),
            span(fid + 1, "crt.pass.eager", t, t + eager * s, fid),
            span(fid + 2, "crt.pass.capture", t + 0.2, t + 0.2 + capture * s,
                 fid, {"device_allocs": allocs[0],
                       "device_frees": allocs[1]}),
            span(fid + 3, "crt.pass.release", t + 0.9,
                 t + 0.9 + release * s, fid)]


def frames_recorder():
    records = (frame(100, 5.0, 999, 999, 999, (500, 500))     # set-up
               + frame(200, 10.0, 120, 250, 30, (47, 47))
               + frame(300, 11.0, 140, 230, 20, (40, 40))
               + frame(400, 12.0, 130, 260, 25, (50, 48))
               + frame(500, 30.0, 500, 500, 500, (1, 1)))     # profiled
    fine = [span(510 + k, "crt.sample", 30.3, 30.4, 500, device_ms=0.5)
            for k in range(4)]
    fine += [span(520 + k, "crt.intersect", 30.3, 30.4, 500, device_ms=0.25)
             for k in range(2)]
    fine += [span(530, "crt.pass", 30.3, 30.4, 500, device_ms=9.0),
             span(531, "crt.sample", 30.3, 30.4, 500),  # eager: no pair
             span(232, "crt.sample", 10.3, 10.4, 200, device_ms=7.0)]
    counts = {500: {"crt.bounce.alive": 912440.0,
                    "crt.bounce.lanes": 1048576},
              200: {"crt.bounce.alive": 1.0, "crt.bounce.lanes": 4}}
    return Recorder(records + fine, counts)


def train_recorder():
    records = [span(1, "crt.job", 5.0, 40.0, 1)]
    for k, (host, launch) in enumerate([(9.0, 8.0), (1.0, 0.5), (2.0, 0.7),
                                        (3.0, 0.9), (9.0, 9.0)]):
        t = 8.0 + 4.0 * k   # 8 (before the window) .. 24 (after it)
        records += [span(10 + 2 * k, "crt.step.host", t, t + host * 1e-3, 1),
                    span(11 + 2 * k, "crt.step.launch", t,
                         t + launch * 1e-3, 1)]
    return Recorder(records)


CTX = types.SimpleNamespace(rec={"t_start": 10.0, "t_end": 20.0})
WANT = {"eager_pass_ms.frames": 130.0, "capture_ms.frames": 250.0,
        "capture_allocs.frames": 94, "release_ms.frames": 25.0,
        "sampler_ms.frames": 2.0, "intersect_ms.frames": 0.5,
        "alive_share.frames": 100.0 * 912440 / 1048576,
        "step_host_ms.train": 2.0, "step_launch_ms.train": 0.7}


@pytest.mark.parametrize("name", FRAMES + TRAIN)
def test_reader_values(monkeypatch, name):
    rec = train_recorder() if name in TRAIN else frames_recorder()
    monkeypatch.setattr(span_readers, "recorder", lambda: rec)
    assert cells.metric(name).read(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", FRAMES + TRAIN)
def test_reader_none_when_nothing_recorded(monkeypatch, name):
    monkeypatch.setattr(span_readers, "recorder", lambda: Recorder([]))
    assert cells.metric(name).read(CTX) is None
    monkeypatch.setattr(span_readers, "recorder", lambda: None)
    assert cells.metric(name).read(CTX) is None


def test_reader_metadata():
    for name in FRAMES + TRAIN:
        reader = cells.metric(name)
        for cell in reader.WORKLOADS:
            assert reader.MOVES in cells.cell(cell)["end_to_end"]


@pytest.mark.parametrize("cell,small", [
    ("cornell.frames", {"view": {"render": {"resolution": [8, 8],
                                            "spp": 2}}}),
    ("cornell.inverse", {"view": {"render": {"resolution": [8, 8],
                                             "spp": 2}}, "steps": 3})])
def test_port_on_cpu(cell, small):
    """The port's recorder read through the harness on the CPU: eager
    passes only (every pass on the CPU), nothing captured or replayed."""
    names = FRAMES if cell == "cornell.frames" else TRAIN
    over = dict(small, per_layer=cells.cell(cell)["per_layer"] + names)
    out = harness.run(cell, 2**31 + 7, 0.3, True, "cpu", override=over)
    got = set(out["metrics"]) & set(names)
    assert got == ({"eager_pass_ms.frames"} if cell == "cornell.frames"
                   else set()), out["metrics"]
