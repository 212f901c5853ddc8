"""The port's resilience subset (``resilience/{retry,faults,supervisor}.py``,
``data/pipeline.RetryingIterator``) and its checkpoint processes, against
the JAX package and against the port's own straight runs.

- ``RetryPolicy``'s seeded delays, ``retry_call``'s counters,
  ``classify_failure`` and ``FaultPlan.seeded`` equal JAX's.
- A ``TransientIOError`` absorbed by the re-seeking ``RetryingIterator``
  leaves the stream bitwise the unfaulted one, with JAX's counts.
- The ``Supervisor``: a fatal error passes through, a transient failure at
  build earns a restart, a permanent one exhausts the budget with JAX's
  counts (in process, no signal); and, in a child process with its own
  timeout, a supervised tiny run under ``Sigterm(3)`` and
  ``CorruptCheckpoint(restart=1)`` takes the restarts, causes and restored
  steps of JAX's ``Supervisor`` on the same plan and ends bitwise equal to
  the port's straight run.
- Processes (``tests/torch_dp_worker.py``'s ``ckpt`` job): two gloo ranks
  of a tiny data-parallel ResNet, SIGTERM to rank 1 only — both save at
  the same agreed step (the next ``preemption_check_every`` boundary) and
  stop cleanly, only the chief writes, both restore the same state and
  resume; one rank with an ``AsyncCommitKill`` dies by SIGKILL leaving
  ``.pending/<step>`` and the older ``latest_step``.
- Processes (the ``ckpt_fallback`` job): two gloo ranks restore with
  ``fallback=True`` past a torn newest step that the chief quarantines;
  both then return the same from a forced save of that step, which
  completes on both.

No signal is sent to the pytest process.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import test_torch_checkpoint as C
import torch_dp_worker as W
from distributed_tensorflow_tpu import resilience as jrz
from distributed_tensorflow_tpu.data.pipeline import RetryingIterator as JRetrying
from distributed_tensorflow_tpu.obs.registry import Registry as JRegistry
from distributed_tensorflow_tpu_torch import resilience as rz
from distributed_tensorflow_tpu_torch.data.pipeline import RetryingIterator
from distributed_tensorflow_tpu_torch.obs.registry import Registry
from distributed_tensorflow_tpu_torch.train import callbacks as tcb
from distributed_tensorflow_tpu_torch.train import checkpoint as tck
from distributed_tensorflow_tpu_torch.train.loop import Trainer

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _sigterm_handler_unchanged():
    before = signal.getsignal(signal.SIGTERM)
    yield
    assert signal.getsignal(signal.SIGTERM) == before


# -- retry, classification, plans ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_retry_delays_equal_jax(seed):
    kw = dict(base_s=0.05, multiplier=2.0, max_backoff_s=1.0, jitter=0.5, seed=seed)
    ours, theirs = rz.RetryPolicy(**kw), jrz.RetryPolicy(**kw)
    assert [ours.backoff_s(i) for i in range(12)] == [theirs.backoff_s(i) for i in range(12)]


@pytest.mark.parametrize("fail_times", [1, 5])
def test_retry_call_counts_like_jax(fail_times):
    def run(mod, registry):
        left = [fail_times]

        def flaky():
            if left[0] > 0:
                left[0] -= 1
                raise OSError("blip")
            return "ok"

        try:
            out = mod.retry_call(flaky, policy=mod.RetryPolicy(max_attempts=3, base_s=0.0),
                                 site="s", registry=registry, sleep=lambda s: None)
        except mod.RetryExhausted as e:
            out = (type(e.__cause__).__name__, e.attempts)
        return out, registry.get("retry_attempts_total", site="s").value, \
            registry.get("retry_exhausted_total", site="s").value

    assert run(rz, Registry()) == run(jrz, JRegistry())


def _cases(mod):
    exhausted_io = mod.RetryExhausted("s", 3, "attempt budget", IOError("x"))
    exhausted_io.__cause__ = IOError("x")
    exhausted_nan = mod.RetryExhausted("s", 3, "attempt budget", FloatingPointError("n"))
    exhausted_nan.__cause__ = FloatingPointError("n")
    return [IOError("io"), TimeoutError("t"), FileNotFoundError("f"), mod.AttemptTimeout("a"),
            FloatingPointError("nan"), ValueError("bug"), KeyboardInterrupt(),
            RuntimeError("r"), exhausted_io, exhausted_nan]


@pytest.mark.parametrize("i", range(10))
def test_classify_failure_agrees_with_jax(i):
    assert rz.classify_failure(_cases(rz)[i]) == jrz.classify_failure(_cases(jrz)[i])


@pytest.mark.parametrize("kinds", [("sigterm",), ("data_error", "nan_batch", "transient_io"),
                                   ("ckpt_corrupt", "async_commit_kill", "slow_writer",
                                    "sigterm")])
def test_seeded_plans_equal_jax(kinds):
    for seed in range(5):
        ours, theirs = rz.FaultPlan.seeded(seed, 40, kinds), jrz.FaultPlan.seeded(seed, 40, kinds)
        assert [(type(f).__name__, vars(f)) for f in ours.faults] == \
            [(type(f).__name__, vars(f)) for f in theirs.faults]


def test_fleet_fault_kinds_are_refused_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 6"):
        rz.FaultPlan.seeded(0, 10, ("pod_outage",))


def test_retrying_iterator_recovers_the_unfaulted_stream_with_jax_counts():
    def run(mod, retrying, registry):
        plan = mod.FaultPlan((mod.TransientIOError(batch=3, times=2),))
        it = retrying(lambda i: plan.wrap(C.tiny_batches(i), start=i),
                      mod.RetryPolicy(max_attempts=4, base_s=0.0, jitter=0.0),
                      registry=registry, sleep=lambda s: None)
        got = [next(it) for _ in range(6)]
        return got, registry.get("retry_attempts_total", site="data").value

    got, n = run(rz, RetryingIterator, Registry())
    want, jn = run(jrz, JRetrying, JRegistry())
    assert n == jn == 2
    for a, b, i in zip(got, want, range(1, 7)):
        for k in a:
            assert np.array_equal(a[k], C.tiny_batch(i)[k]) and np.array_equal(a[k], b[k])


# -- the Supervisor, in process (no signal) -----------------------------------


def _port_builder(workdir, plan, registry, starts, save_every=2, extra=lambda: [],
                  retry=None, preemption=False):
    """An attempt: a fresh Checkpointer (with a SIGTERM watcher only where
    ``preemption``: in a child process), fallback restore, a Trainer with
    the checkpoint and fault callbacks, the stream re-seekable at the
    restored step (as JAX's test_supervisor builder)."""

    def build(restart_index):
        ckpt = tck.Checkpointer(tck.CheckpointConfig(
            directory=str(workdir), save_interval_steps=save_every, async_save=False,
            save_on_preemption=preemption, preemption_check_every=1), registry=registry)
        state = C.tiny_state("sgd", lr=0.1)
        try:
            state, _ = tck.init_or_restore(ckpt, state, fallback=True)
        except BaseException:
            ckpt.close()
            raise
        starts.append(state.step)
        trainer = Trainer(C.tiny_step(state), state,
                          callbacks=extra() + [tcb.CheckpointCallback(ckpt), plan.callback()])
        data = RetryingIterator(
            lambda i: plan.wrap(C.tiny_batches(i), start=i),
            retry or rz.RetryPolicy(max_attempts=4, base_s=0.0, jitter=0.0),
            start_index=state.step, registry=registry, sleep=lambda s: None)
        return trainer, data, ckpt

    return build


def _fast(**kw):
    return rz.SupervisorConfig(backoff=rz.RetryPolicy(base_s=0.0, jitter=0.0), **kw)


def test_supervisor_fatal_passes_through(tmp_path):
    class Boom(tcb.Callback):
        def on_step_end(self, trainer, step, metrics):
            if step == 2:
                raise ValueError("a bug, not the weather")

    reg = Registry()
    sup = rz.Supervisor(_port_builder(tmp_path, rz.FaultPlan(), reg, [],
                                      extra=lambda: [Boom()]),
                        num_steps=8, cfg=_fast(), registry=reg, sleep=lambda s: None)
    with pytest.raises(ValueError, match="a bug"):
        sup.run()
    assert sup.restarts == 0


def test_supervisor_transient_build_failure_earns_a_restart(tmp_path):
    reg, starts = Registry(), []
    inner, flaky = _port_builder(tmp_path, rz.FaultPlan(), reg, starts), [1]

    def build(i):
        if flaky[0]:
            flaky[0] -= 1
            raise IOError("restore-time blip")
        return inner(i)

    state = rz.Supervisor(build, num_steps=4, cfg=_fast(), registry=reg,
                          sleep=lambda s: None).run()
    assert state.step == 4
    assert reg.get("supervisor_restarts_total", cause="transient").value == 1.0


def test_supervisor_exhaustion_counts_like_jax(tmp_path):
    reg, starts = Registry(), []
    plan = rz.FaultPlan((rz.TransientIOError(batch=3, times=10 ** 9),))
    sup = rz.Supervisor(_port_builder(tmp_path, plan, reg, starts, retry=rz.RetryPolicy(
        max_attempts=3, base_s=0.0, jitter=0.0)), num_steps=8, cfg=_fast(max_restarts=2),
        registry=reg, sleep=lambda s: None)
    with pytest.raises(rz.SupervisorExhausted) as ei:
        sup.run()
    assert ei.value.cause == rz.TRANSIENT and ei.value.restarts == 2
    assert isinstance(ei.value.__cause__, rz.RetryExhausted)
    # JAX's test_supervisor_retry_exhausted_classified_and_counted: 3, 6, 2
    assert reg.get("retry_exhausted_total", site="data").value == 3.0
    assert reg.get("retry_attempts_total", site="data").value == 6.0
    assert reg.get("supervisor_restarts_total", cause="transient").value == 2.0
    assert starts == [0, 2, 2]  # each restart resumes at the cadence save of step 2


# -- the Supervisor under Sigterm + CorruptCheckpoint, in a child process -----


def supervised_runs(workdir: str) -> dict:
    """In a child process: JAX's and the port's Supervisor on the plan
    ``(Sigterm(3), CorruptCheckpoint(restart=1))``, and the port's
    straight run. Returns what the test compares."""
    import jax
    import optax

    jax.config.update("jax_platforms", "cpu")
    from distributed_tensorflow_tpu.parallel import MeshSpec, build_mesh
    from test_supervisor import _builder, _fast_cfg

    out = {}
    faults = lambda m: m.FaultPlan((m.Sigterm(3), m.CorruptCheckpoint(restart=1)))  # noqa
    jdir, pdir = os.path.join(workdir, "jax"), os.path.join(workdir, "port")
    reg, starts, plan = JRegistry(), [], faults(jrz)
    sup = jrz.Supervisor(_builder(jdir, build_mesh(MeshSpec(data=8), jax.devices()[:8]), plan,
                                  reg, tx=optax.sgd(0.1), save_every=2, starts=starts),
                         num_steps=8, cfg=_fast_cfg(), registry=reg,
                         on_restart=[plan.restart_hook(jdir)], sleep=lambda s: None)
    out["jax"] = dict(step=int(sup.run().step), restarts=sup.restarts, starts=starts,
                      causes={c: reg.get("supervisor_restarts_total", cause=c).value
                              for c in ("preemption", "transient")
                              if reg.get("supervisor_restarts_total", cause=c)},
                      corrupt=sorted(os.listdir(os.path.join(jdir, ".corrupt"))))
    reg, starts, plan = Registry(), [], faults(rz)
    sup = rz.Supervisor(_port_builder(pdir, plan, reg, starts, preemption=True), num_steps=8,
                        cfg=_fast(),
                        registry=reg, on_restart=[plan.restart_hook(pdir)],
                        sleep=lambda s: None)
    state = sup.run()
    out["port"] = dict(step=state.step, restarts=sup.restarts, starts=starts,
                       causes={c: reg.get("supervisor_restarts_total", cause=c).value
                               for c in ("preemption", "transient")
                               if reg.get("supervisor_restarts_total", cause=c)},
                       corrupt=sorted(os.listdir(os.path.join(pdir, ".corrupt"))))
    straight = C.tiny_state("sgd", lr=0.1)
    Trainer(C.tiny_step(straight), straight).fit(C.tiny_batches(0), num_steps=8)
    got, want = C.leaves_np(state), C.leaves_np(straight)
    out["bitwise"] = got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)
    out["handler_restored"] = signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    return out


def _child(code: str, timeout: float) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(TESTS), TESTS]),
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_supervised_sigterm_and_corruption_match_jax_and_the_straight_run(tmp_path):
    stdout = _child("import json, test_torch_resilience as t; "
                    f"print('RESULT', json.dumps(t.supervised_runs({str(tmp_path)!r})))", 180)
    res = json.loads(stdout.split("RESULT ", 1)[1])
    # SIGTERM after step 3 -> the agreed save at step 4 -> restart 1
    # (preemption) -> step 4 truncated at the restart boundary -> fallback
    # quarantines 4 and restores 2 -> the run ends at 8
    assert res["port"] == res["jax"] == dict(step=8, restarts=1, starts=[0, 2],
                                              causes={"preemption": 1.0}, corrupt=["4"])
    assert res["bitwise"] and res["handler_restored"]


# -- processes: the ckpt job of tests/torch_dp_worker.py ----------------------


def test_two_ranks_agree_on_the_preemption_step_and_restore_alike():
    from test_torch_train_workload import RESNET_TINY

    with tempfile.TemporaryDirectory() as d:
        spec = {"job": "ckpt", "device": "cpu", "out": d, "workload": "resnet50_imagenet",
                "overrides": RESNET_TINY + [
                    "--mesh.data=2", f"--checkpoint.directory={d}/ck",
                    "--checkpoint.save_interval_steps=2", "--checkpoint.max_to_keep=5",
                    "--checkpoint.preemption_check_every=2", "--train.eval_batches=0"],
                "runs": [{"num_steps": 6, "sigterm": {"1": 3}}, {"num_steps": 6}]}
        procs = W.launch(spec, 2)
        try:
            r0, r1 = W.wait(procs, d, timeout=150)
        except BaseException:
            W.stop(procs)
            raise
        steps = sorted(int(n) for n in os.listdir(f"{d}/ck") if n.isdigit())
    for r in (r0, r1):
        # SIGTERM after step 3 on rank 1 alone; the agreement runs at step 4
        assert list(r["run0/steps"]) == [1, 2, 3, 4] and bool(r["run0/preempted"])
        assert list(r["run1/steps"]) == [5, 6] and not bool(r["run1/preempted"])
    assert (int(r0["run0/commits"]), int(r1["run0/commits"])) == (3, 0)  # steps 1, 2, 4
    assert (int(r0["run1/commits"]), int(r1["run1/commits"])) == (1, 0)  # step 6
    assert steps == [1, 2, 4, 6]
    for k in r0:
        if "/start/" in k or "/end/" in k:
            assert np.array_equal(r0[k], r1[k]), k
    assert float(r0["run1/start/step"]) == 4.0
    for k in r0:  # the resumed run starts from the preempted run's end
        if k.startswith("run1/start/"):
            assert np.array_equal(r0[k], r0["run0/end/" + k[len("run1/start/"):]]), k


def test_async_commit_kill_leaves_the_step_pending_and_latest_unchanged():
    from test_torch_train_workload import TINY

    with tempfile.TemporaryDirectory() as d:
        spec = {"job": "ckpt", "device": "cpu", "out": d, "workload": "gpt_lm",
                "overrides": TINY + [f"--checkpoint.directory={d}/ck",
                                     "--checkpoint.save_interval_steps=2",
                                     "--train.eval_batches=0"],
                "runs": [{"num_steps": 6, "kill_at": 4}]}
        (proc, log), = W.launch(spec, 1)
        try:
            code = proc.wait(120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        assert code == -signal.SIGKILL, open(f"{d}/rank0.log").read()[-3000:]
        assert os.listdir(f"{d}/ck/.pending") == ["4"]
        assert "MANIFEST.dtf" not in os.listdir(f"{d}/ck/.pending/4")
        ckpt = tck.Checkpointer(tck.CheckpointConfig(directory=f"{d}/ck",
                                                     save_on_preemption=False))
        try:
            assert ckpt.latest_step() == 2
            assert not os.path.exists(f"{d}/ck/.pending/4")  # a new writer drops it
        finally:
            ckpt.close()


def test_two_ranks_agree_after_a_fallback_restore_quarantines_a_torn_step():
    with tempfile.TemporaryDirectory() as d:
        spec = {"job": "ckpt_fallback", "device": "cpu", "out": d, "dir": f"{d}/ck",
                "cfg": dict(stage_sizes=(1, 1), width=8, num_classes=10, dtype="float32")}
        procs = W.launch(spec, 2)
        try:
            r0, r1 = W.wait(procs, d, timeout=90)
        except BaseException:
            W.stop(procs)
            raise
        corrupt = os.listdir(f"{d}/ck/.corrupt")
    assert corrupt == ["4"]
    for r in (r0, r1):
        assert bool(r["restored"]) and int(r["restored_step"]) == 2
        assert bool(r["saved"]) and bool(r["verified"])
        assert list(r["known"]) == [2, 4]
