"""The port's summary writer, telemetry, watchdog and profiler callbacks
against the JAX package's.

- ``SummaryWriter`` writes TensorBoard event files itself: TensorFlow's
  ``summary_iterator`` reads them (checking every CRC), and they hold the
  tags, steps and values of the file tensorboardX writes for the JAX
  ``SummaryWriter`` on the same metrics; ``read_records`` checks the CRCs
  and refuses a flipped byte.
- ``TelemetryCallback`` leaves the registry the JAX one leaves (every
  metric's name, labels and value) for the same metrics and clock, but
  for the zero waste counters of causes only the JAX fleet books.
- ``Watchdog`` on an injected clock flags a stall once, records it in the
  flight recorder, clears on the next step and, with ``abort_on_stall``,
  raises ``StalledError`` in the loop (main thread: by signal; another
  thread: asynchronously), which ``classify_failure`` calls ``stalled``.
- ``Profiler`` writes a Chrome trace of the window's steps on the CPU.

Values are f32 scalars; the event files hold them as f32, so they compare
exactly.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import tensorflow as tf
import torch

from distributed_tensorflow_tpu import obs as jobs
from distributed_tensorflow_tpu.train import callbacks as jcb
from distributed_tensorflow_tpu_torch.obs import flightrec
from distributed_tensorflow_tpu_torch.obs.registry import Registry
from distributed_tensorflow_tpu_torch.resilience.supervisor import STALLED, classify_failure
from distributed_tensorflow_tpu_torch.train import callbacks as tcb


class StubTrainer:
    def __init__(self):
        self.stop_reason = None
        self.failed = False

    def request_stop(self, reason=""):
        self.stop_reason = self.stop_reason or reason or "requested"


class FakeClock:
    """Advances ``dt`` a call."""

    def __init__(self, dt=0.5, t0=100.0):
        self.t, self.dt = t0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _metrics(step):
    return {"loss": np.float32(3.0 / step), "accuracy": np.float32(0.1 * step)}


def _events(path):
    out = []
    for e in tf.compat.v1.train.summary_iterator(path):
        for v in e.summary.value:
            out.append((v.tag, int(e.step), float(v.simple_value)))
    return out


def _drive(writer, logger, steps=8):
    t = StubTrainer()
    logger.on_train_start(t)
    writer.on_train_start(t)
    for step in range(1, steps + 1):
        logger.on_step_end(t, step, _metrics(step))
        writer.on_step_end(t, step, _metrics(step))
    writer.on_train_end(t)


def test_event_file_matches_tensorboardx_of_the_jax_writer(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_logger = jcb.MetricsLogger(every_n=4, clock=FakeClock())
    _drive(jcb.SummaryWriter(jdir, every_n=2, metrics_logger=jax_logger), jax_logger)
    port_logger = tcb.MetricsLogger(every_n=4, clock=FakeClock())
    _drive(tcb.SummaryWriter(tdir, every_n=2, metrics_logger=port_logger), port_logger)
    (jfile,), (tfile,) = os.listdir(jdir), os.listdir(tdir)
    assert tfile.startswith("events.out.tfevents.")
    want = _events(os.path.join(jdir, jfile))
    got = _events(os.path.join(tdir, tfile))
    # the logger's derived scalars (steps_per_sec) exist only at its steps
    want_core = [w for w in want if w[0] in ("train/loss", "train/accuracy")]
    got_core = [g for g in got if g[0] in ("train/loss", "train/accuracy")]
    assert sorted(got_core) == sorted(want_core) and len(want_core) == 8
    # the paired logger's rate, from its second fetch on (step 8), on both
    rate = lambda events: {e[1] for e in events if e[0] == "train/steps_per_sec"}  # noqa: E731
    assert rate(got) == rate(want) == {8}
    first = next(iter(tf.compat.v1.train.summary_iterator(os.path.join(tdir, tfile))))
    assert first.file_version == "brain.Event:2"


def test_records_carry_masked_crc32c_and_a_flipped_byte_is_refused(tmp_path):
    assert tcb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    w = tcb.EventFileWriter(str(tmp_path))
    w.add_scalar("train/loss", 1.25, 7)
    w.close()
    recs = tcb.read_records(w.path)
    assert len(recs) == 2 and recs[1] == tcb.event_bytes(
        tf.compat.v1.Event.FromString(recs[1]).wall_time, 7, scalars={"train/loss": 1.25})
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 1
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bad data CRC"):
        tcb.read_records(w.path)


def test_telemetry_registry_equals_the_jax_one():
    """Ten steps with a paired logger every 2 and telemetry every 2, and a
    pause, on the same clocks: every metric the JAX callback leaves in its
    registry (histogram buckets, counters, gauges, the goodput ledger)
    the port's leaves with the same value."""
    regs = []
    for cb, reg in ((jcb, jobs.Registry()), (tcb, Registry())):
        clock = FakeClock()
        ml = cb.MetricsLogger(every_n=2, batch_size=4, clock=clock)
        tc = cb.TelemetryCallback(registry=reg, every_n=2, metrics_logger=ml, clock=clock)
        t = StubTrainer()
        ml.on_train_start(t)
        tc.on_train_start(t)
        for step in range(1, 11):
            ml.on_step_end(t, step, _metrics(step))
            tc.on_step_end(t, step, _metrics(step))
            if step == 5:
                tc.note_pause(0.25)
        regs.append(reg.snapshot())
    jsnap, tsnap = regs
    assert len(tsnap) > 10
    for key, metric in tsnap.items():
        assert json.dumps(metric, sort_keys=True) == json.dumps(jsnap[key], sort_keys=True), key
    # what only JAX has: the waste causes of its fleet (zero here)
    for key in set(jsnap) - set(tsnap):
        assert jsnap[key]["name"] == "wasted_seconds_total" and jsnap[key]["value"] == 0, key


def test_telemetry_counts_steps():
    reg = Registry()
    tc = tcb.TelemetryCallback(registry=reg, every_n=3, clock=FakeClock())
    tc.on_train_start(StubTrainer())
    for step in range(1, 7):
        tc.on_step_end(None, step, _metrics(step))
    assert reg.get("train_steps_total").value == 6
    assert reg.get("train_step_seconds").count == 5
    assert reg.get("train_loss").value == pytest.approx(0.5)


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.002)
    return pred()


def test_watchdog_flags_a_stall_once_and_clears():
    reg, clk, rec = Registry(), ManualClock(), flightrec.FlightRecorder()
    wd = tcb.Watchdog(budget_s=5.0, registry=reg, poll_s=0.002, clock=clk, flightrec=rec)
    wd.on_train_start(StubTrainer())
    try:
        clk.t = 4.0
        time.sleep(0.02)
        assert reg.get("train_watchdog_stalled").value == 0.0
        clk.t = 6.0
        assert _wait_for(lambda: reg.get("train_watchdog_stalled").value == 1.0)
        time.sleep(0.02)
        assert reg.get("train_watchdog_stalls_total").value == 1
        wd.on_step_end(None, 1, {})
        assert reg.get("train_watchdog_stalled").value == 0.0
    finally:
        wd.on_train_end(None)
    kinds = [e for e in rec.events() if e["kind"] == "watchdog_stall"]
    assert len(kinds) == 1 and kinds[0]["budget_s"] == 5.0 and kinds[0]["abort"] is False
    assert wd._thread is None


def test_watchdog_abort_on_stall_raises_stalled_error_classified_stalled():
    """Main thread: the abort arrives by signal and raises in the loop."""
    reg, clk = Registry(), ManualClock()
    wd = tcb.Watchdog(budget_s=5.0, registry=reg, poll_s=0.005, clock=clk,
                      flightrec=flightrec.FlightRecorder(), abort_on_stall=True)
    wd.on_train_start(StubTrainer())
    try:
        clk.t = 100.0
        with pytest.raises(tcb.StalledError) as err:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:  # the hung loop
                time.sleep(0.001)
            raise AssertionError("the watchdog never aborted the loop")
    finally:
        wd.on_train_end(None)
    assert classify_failure(err.value) == STALLED
    assert reg.get("train_watchdog_stalls_total").value == 1


def test_watchdog_aborts_a_loop_on_another_thread():
    reg, clk, caught = Registry(), ManualClock(), []
    wd = tcb.Watchdog(budget_s=5.0, registry=reg, poll_s=0.005, clock=clk,
                      flightrec=flightrec.FlightRecorder(), abort_on_stall=True)

    def loop():
        wd.on_train_start(StubTrainer())
        try:
            clk.t = 100.0
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                time.sleep(0.001)
        except tcb.StalledError as e:
            caught.append(e)
        finally:
            wd.on_train_end(None)

    th = threading.Thread(target=loop)
    th.start()
    th.join(timeout=15.0)
    assert not th.is_alive() and len(caught) == 1


def test_profiler_writes_a_chrome_trace_on_the_cpu(tmp_path):
    prof = tcb.Profiler(str(tmp_path), start_step=1, num_steps=2)
    x = torch.randn(32, 32)
    for step in range(1, 5):
        torch.mm(x, x)
        prof.on_step_end(None, step, {})
    prof.on_train_end(None)
    assert prof.path == str(tmp_path / "trace_rank0_steps1-3.json")
    events = json.load(open(prof.path))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_runner_writes_summaries_and_a_profile(tmp_path):
    """``--train.summary_dir`` and ``--train.profile``: the runner places
    the SummaryWriter after the MetricsLogger (its rate scalars are in the
    file) and the Profiler over steps 10-15."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_train_workload import TINY

    from distributed_tensorflow_tpu_torch.workloads import run_workload

    res = run_workload("gpt_lm", TINY + [
        "--train.num_steps=15", "--train.eval_batches=0", f"--train.summary_dir={tmp_path}/tb",
        "--train.profile=true", f"--train.profile_dir={tmp_path}/prof"], device="cpu")
    assert res.state.step == 15
    (name,) = os.listdir(tmp_path / "tb")
    events = _events(str(tmp_path / "tb" / name))
    assert [s for tag, s, _ in events if tag == "train/loss"] == list(range(1, 16))
    assert {tag for tag, _, _ in events} >= {"train/loss", "train/accuracy",
                                              "train/steps_per_sec"}
    assert os.listdir(tmp_path / "prof") == ["trace_rank0_steps10-15.json"]
