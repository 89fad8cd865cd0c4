"""The five ``setup_*`` readers: the self seconds of their stages in the
port's set-up record, 0.0 for a stage the process did not run, nothing for
a port without the record; their stages are the port's."""

import json
import os
import types

import pytest

from gpubench import core, setup_stages
from short_ldpc_decoding_osd_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SETUP_METRICS = [m for m in SPEC["per_layer"] if m["layer"] == "set-up"]

# a set-up record: self seconds 0.5 import, 0.25 device, 3.5 load_run (two
# calls, inside two_phase), 4 two_phase, 8 kernels (inside the first unit),
# 16 first_unit (two calls)
FAKE = {"spans": {
    "setup.import": {"calls": 1, "seconds": 0.5, "self_seconds": 0.5,
                     "parents": {None: 1}},
    "setup.device": {"calls": 1, "seconds": 0.25, "self_seconds": 0.25,
                     "parents": {None: 1}},
    "setup.load_run": {"calls": 2, "seconds": 3.5, "self_seconds": 3.5,
                       "parents": {"setup.two_phase": 2}},
    "setup.two_phase": {"calls": 1, "seconds": 7.5, "self_seconds": 4.0,
                        "parents": {None: 1}},
    "setup.kernels": {"calls": 1, "seconds": 8.0, "self_seconds": 8.0,
                      "parents": {"setup.first_unit": 1}},
    "setup.first_unit": {"calls": 2, "seconds": 24.0, "self_seconds": 16.0,
                         "parents": {None: 2}},
}, "kernels_built": 5}
WANT = {"setup_import_s": 0.5, "setup_device_s": 0.25, "setup_load_s": 7.5,
        "setup_kernels_s": 8.0, "setup_first_unit_s": 16.0}
CTX = types.SimpleNamespace(kind="system", trace=None)


def _read(name):
    return core.metric_reader(name)(CTX)


def test_the_five_metrics_and_their_spec():
    assert [m["name"] for m in SETUP_METRICS] == list(setup_stages.READS)
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SETUP_METRICS:
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "s", "lower", "host_clock", "setup_s"), m["name"]
        assert m["workloads"] == cells, m["name"]


@pytest.mark.parametrize("name", list(WANT))
def test_reader_adds_the_self_seconds_of_its_stages(name, monkeypatch):
    monkeypatch.setattr(profiling, "setup_snapshot", lambda: FAKE)
    assert _read(name) == WANT[name]


@pytest.mark.parametrize("name", list(WANT))
def test_a_stage_that_did_not_run_reads_zero(name, monkeypatch):
    spans = {k: v for k, v in FAKE["spans"].items()
             if k not in setup_stages.READS[name]}
    monkeypatch.setattr(profiling, "setup_snapshot",
                        lambda: {"spans": spans, "kernels_built": 0})
    got = _read(name)
    assert got == 0.0 and isinstance(got, float)


def test_the_five_add_up_to_the_record():
    """Over every stage, the readings add up to the top-level spans'
    inclusive seconds: nothing counts twice."""
    top = sum(s["seconds"] for s in FAKE["spans"].values() if None in s["parents"])
    assert sum(WANT.values()) == top


def test_readers_name_the_ports_stages():
    read = [s for stages in setup_stages.READS.values() for s in stages]
    assert sorted(read) == sorted(profiling.SETUP_STAGES)
    assert len(read) == len(set(read))


def test_a_renamed_stage_fails_the_reading(monkeypatch):
    monkeypatch.setattr(profiling, "SETUP_STAGES", tuple(
        "setup.load" if s == "setup.load_run" else s
        for s in profiling.SETUP_STAGES))
    with pytest.raises(KeyError, match="setup.load_run"):
        _read("setup_load_s")


def test_a_port_without_the_record_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "setup_snapshot")
    assert all(_read(name) is None for name in WANT)
    assert core.read_metrics(SETUP_METRICS, CTX) == {}


def test_readers_read_the_live_record():
    """In this process the readers read the port's own record: a number
    each, whatever stages ran."""
    got = {name: _read(name) for name in WANT}
    snap = profiling.setup_snapshot()
    for name, value in got.items():
        assert value == setup_stages.self_seconds(snap, setup_stages.READS[name])
        assert value >= 0.0
