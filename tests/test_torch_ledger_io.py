"""The port's telemetry writers with fewer system calls: the ledger's
append (`os.open` / `os.write` / `os.close`, the size kept in memory),
the heartbeat's write and one read of the card's memory a tick. Each
file they write reads the same through the JAX package's readers as
through the port's. CPU only: no search runs here.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.telemetry import health as jhealth  # noqa: E402
from alphatriangle_tpu.telemetry import ledger as jledger  # noqa: E402
from alphatriangle_tpu_torch.telemetry import RunTelemetry, TelemetryConfig  # noqa: E402
from alphatriangle_tpu_torch.telemetry import health as thealth  # noqa: E402
from alphatriangle_tpu_torch.telemetry import ledger as tledger  # noqa: E402
from alphatriangle_tpu_torch.telemetry.perf import UtilizationMeter  # noqa: E402

MEMORY = [{"device": 0, "kind": "cpu", "bytes_in_use": 7 << 20, "bytes_limit": 80 << 30,
           "peak_bytes_in_use": 9 << 20}]


@pytest.mark.parametrize("flags", ["replace", "append"])
def test_write_bytes_makes_the_directory_once_missing(tmp_path, flags):
    """The open makes the missing parent directory and writes every byte;
    a second write truncates or appends."""
    path = tmp_path / "a" / "b" / "f.jsonl"
    mode = tledger._REPLACE_FLAGS if flags == "replace" else tledger._APPEND_FLAGS
    tledger.write_bytes(path, b"one\n", mode)
    tledger.write_bytes(path, b"two\n", mode)
    assert path.read_bytes() == (b"two\n" if flags == "replace" else b"one\ntwo\n")


def test_ledger_recreates_its_directory(tmp_path):
    """A run directory removed under a live writer comes back at the next
    append, as it did when every append made the directory."""
    path = tmp_path / "run" / "metrics.jsonl"
    led = tledger.MetricsLedger(path)
    assert led.append({"kind": "util", "step": 1})
    path.unlink()
    path.parent.rmdir()
    assert led.append({"kind": "util", "step": 2})
    assert [r["step"] for r in jledger.read_ledger(path)] == [2]


@pytest.mark.parametrize("writers", [1, 2])
def test_rotation_with_the_size_in_memory(tmp_path, writers):
    """Rotation at the same record as a writer that reads the size every
    append (the JAX ledger), with one writer; with two on one file, none
    rotates early, no record is lost or spans files and both packages
    read the same records in order."""
    path = tmp_path / "metrics.jsonl"
    ours = [tledger.MetricsLedger(path, max_bytes=300, keep=5) for _ in range(writers)]
    records = [{"kind": "util", "step": step, "pad": "x" * 30} for step in range(1, 19)]
    for i, rec in enumerate(records):
        assert ours[i % writers].append(rec)
    files = tledger.ledger_paths(path)
    assert tledger.read_ledger(path) == records == jledger.read_ledger(path)
    assert all(p.read_text().endswith("\n") for p in files)
    if writers == 1:
        ref_path = tmp_path / "ref" / "metrics.jsonl"
        ref = jledger.MetricsLedger(ref_path, max_bytes=300, keep=5)
        for rec in records:
            ref.append(rec)
        assert [p.read_bytes() for p in files] == [p.read_bytes() for p in jledger.ledger_paths(ref_path)]
    else:
        # Late, never early: every rotated file reached the limit less one record.
        line = len(json.dumps(records[0])) + 1
        assert all(p.stat().st_size > 300 - line for p in files[:-1])


def test_heartbeat_carries_the_memory_of_the_tick(tmp_path, monkeypatch):
    """`on_util_tick` reads the card's memory once; the heartbeat that
    `on_tick` writes next carries that read, and a heartbeat with no tick
    before it reads the memory itself. The file reads the same through
    both packages' readers."""
    reads = []

    def memory():
        reads.append(1)
        return MEMORY

    monkeypatch.setattr("alphatriangle_tpu_torch.telemetry.device_memory_stats", memory)
    monkeypatch.setattr(thealth, "device_memory_stats", memory)
    tel = RunTelemetry(
        TelemetryConfig(), run_dir=tmp_path, perf=UtilizationMeter(forward_flops=1000, device_kind="cpu")
    )
    for step in (1, 2):
        tel.on_util_tick(step, experiences=step)
        tel.on_tick(step, buffer_size=step)
    assert len(reads) == 2
    health = thealth.read_health(tmp_path / "health.json")
    assert health["device_memory"] == MEMORY and health["learner_step"] == 0
    assert jhealth.read_health(tmp_path / "health.json") == health
    tel.on_tick(3, buffer_size=3)
    assert len(reads) == 3
    assert not (tmp_path / "health.json.tmp").exists()
    tel.close(step=3)


def test_heartbeat_write_makes_its_directory(tmp_path):
    """The heartbeat's first write makes the run directory; a failed
    write is logged, never raised."""
    monitor = thealth.HealthMonitor(tmp_path / "new" / "health.json", deadline_s=60.0, run_name="r")
    monitor.write(MEMORY)
    assert thealth.read_health(monitor.path)["device_memory"] == MEMORY
    (tmp_path / "file").write_text("")
    thealth.HealthMonitor(tmp_path / "file" / "health.json", deadline_s=60.0).write([])
