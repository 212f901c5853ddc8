"""The port's checkpointing (``train/checkpoint.py``, the emergency save of
``train/loop.py``, the runner's resume) against the JAX package and
against its own straight runs, on the CPU at tiny sizes.

- **Layout.** The JAX package's own ``faults.truncate_shard`` /
  ``corrupt_shard`` on a port step directory: the port's checks catch
  them, and the committed, quarantined and restored steps equal those of
  JAX's ``Checkpointer`` in the same scenario (same cadence, retention and
  fault).
- **Semantics.** Back-to-back async saves race retention; nothing is
  visible before the publish rename; a failed commit poisons the next
  save; ``validate_before_save`` refuses a NaN in the parameters, the
  Adam moments or a buffer; the emergency save runs on a callback or data
  fault and is refused for a fault inside the update; an async save's
  snapshot is the step-boundary state even when its commit is delayed past
  later in-place updates; a bf16 leaf round-trips as its bits.
- **Training parity.** Tiny ``gpt_lm`` from JAX's initial weights: 2 steps
  + save + resume 2 is bitwise the port's straight 4-step run, and its
  resumed losses are within 1e-5 of JAX's resumed run (the runner with
  ``checkpoint.directory`` on both sides; 1e-5 is the port-vs-JAX loss
  tolerance of ``test_torch_train_step.py``). A JAX adamw or momentum state
  at step 2 carried across by ``optimizer_state_from_jax`` continues 2
  steps in the port within 1e-5 of JAX's steps 3-4 (losses; parameters
  1e-5, as ``test_three_adamw_steps_match_optax``).

No test here sends a signal: the SIGTERM and SIGKILL faults run in child
processes (``test_torch_resilience.py``). Every ``Checkpointer`` is closed
by the ``ckpts`` fixture.
"""

import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu import resilience as jrz
from distributed_tensorflow_tpu.train import CheckpointConfig as JConfig
from distributed_tensorflow_tpu.train import Checkpointer as JCheckpointer
from distributed_tensorflow_tpu.train import init_or_restore as j_init_or_restore
from distributed_tensorflow_tpu_torch import resilience as rz
from distributed_tensorflow_tpu_torch.obs import flightrec
from distributed_tensorflow_tpu_torch.runtime import io as tio
from distributed_tensorflow_tpu_torch.train import callbacks as tcb
from distributed_tensorflow_tpu_torch.train import checkpoint as tck
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.train.loop import Trainer

from test_step import linear_init


# -- a tiny trainable state (also test_torch_resilience.py's) ----------------


class TinyRegressor(torch.nn.Module):
    """``x @ w + b`` (the JAX tests' ``linear_init`` / ``linear_loss``
    shape, 8 -> 4) with a buffer its train forward updates, as BatchNorm's
    running statistics are."""

    def __init__(self, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(0.1 * torch.randn(8, 4, generator=g))
        self.b = torch.nn.Parameter(torch.zeros(4))
        self.register_buffer("running_mean", torch.zeros(8))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * x.mean(0))
        return x @ self.w + self.b


def tiny_state(optimizer: str = "adamw", seed: int = 0, lr: float = 1e-2):
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.train import step as tstep

    model = TinyRegressor(seed)
    opt = topt.make_optimizer(topt.OptimizerConfig(name=optimizer, learning_rate=lr),
                              model.parameters())
    return tstep.init_train_state(model, opt)


def tiny_step(state, **options):
    """The port's train step over ``state``'s model (mean squared error)."""
    from distributed_tensorflow_tpu_torch.train import step as tstep

    def loss_fn(batch, gen):
        loss = ((state.model(batch["x"]) - batch["y"]) ** 2).mean()
        return loss, {"mse": loss}

    return tstep.make_train_step(loss_fn, tstep.StepOptions(**options))


def tiny_batch(i: int) -> dict:
    """The batch of global step ``i`` (a pure function of ``i``): the JAX
    tests' ``make_batch(16, seed=1000 + i)``."""
    rng = np.random.RandomState(1000 + i)
    return {"x": rng.randn(16, 8).astype(np.float32), "y": rng.randn(16, 4).astype(np.float32)}


def tiny_batches(start: int):
    """Batches from global step ``start + 1`` on."""
    i = start
    while True:
        i += 1
        yield tiny_batch(i)


def leaves_np(state) -> dict:
    """Every checkpoint leaf of a port state as a numpy copy (bf16 as its
    bits, int16), for bitwise comparisons."""
    from distributed_tensorflow_tpu_torch.train import step as tstep

    def host(t):
        t = t.detach().cpu().clone()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()

    return {n: host(t) for n, t in tstep.state_leaves(state)}


@pytest.fixture(autouse=True)
def _sigterm_handler_unchanged():
    before = signal.getsignal(signal.SIGTERM)
    yield
    assert signal.getsignal(signal.SIGTERM) == before


@pytest.fixture
def ckpts():
    """``make(directory, **config)``: a port Checkpointer (no SIGTERM
    watcher, a one-attempt IO budget unless given), closed at teardown."""
    made = []

    def make(directory, io_retry=None, **kw):
        kw.setdefault("save_on_preemption", False)
        c = tck.Checkpointer(tck.CheckpointConfig(directory=str(directory), **kw),
                             io_retry=io_retry or rz.RetryPolicy(max_attempts=1, base_s=0.0))
        made.append(c)
        return c

    yield make
    for c in made:
        try:
            c.close()
        except Exception:  # a test that provoked a stored failure already checked it
            pass


def _digits(d) -> list[int]:
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def _assert_leaves_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -- layout: the JAX package's fault helpers on a port directory ---------------


def _jax_scenario(d, mesh, damage):
    ckpt = JCheckpointer(JConfig(directory=str(d), save_interval_steps=2, max_to_keep=2,
                                 async_save=True, save_on_preemption=False),
                         mesh, io_retry=jrz.RetryPolicy(max_attempts=1, base_s=0.0))
    try:
        state, _, _ = j_init_or_restore(ckpt, linear_init, optax.sgd(0.1), mesh,
                                        jax.random.PRNGKey(0))
        for s in range(1, 7):
            ckpt.maybe_save(s, state.replace(step=jnp.asarray(s, jnp.int32)))
        ckpt.wait()
        committed = _digits(d)
        damage(str(d), committed[-1])
        abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        restored = ckpt.restore(abstract, fallback=True)
        return committed, int(restored.step), _digits(d)
    finally:
        ckpt.close()


def _port_scenario(d, ckpts, damage):
    ckpt = ckpts(d, save_interval_steps=2, max_to_keep=2)
    state = tiny_state()
    for s in range(1, 7):
        state.step = s
        ckpt.maybe_save(s, state)
    ckpt.wait()
    committed = _digits(d)
    damage(str(d), committed[-1])
    restored = ckpt.restore(tiny_state(), fallback=True)
    return committed, restored.step, _digits(d)


@pytest.mark.parametrize("damage", ["truncate_shard", "corrupt_shard"])
def test_jax_fault_helpers_on_port_steps_match_jax_checkpointer(tmp_path, mesh8, ckpts,
                                                                damage):
    fault = getattr(jrz, damage)
    want = _jax_scenario(tmp_path / "jax", mesh8, fault)
    got = _port_scenario(tmp_path / "port", ckpts, fault)
    assert got == want == ([4, 6], 4, [4])
    assert os.listdir(tmp_path / "port" / ".corrupt") == ["6"]
    assert os.listdir(tmp_path / "jax" / ".corrupt") == ["6"]
    note = (tmp_path / "port" / ".corrupt" / "6" / "QUARANTINE").read_text()
    assert ("bytes" if damage == "truncate_shard" else "CRC") in note


def test_port_checks_catch_the_jax_helpers(tmp_path, ckpts):
    ckpt = ckpts(tmp_path, async_save=False)
    ckpt.save(1, tiny_state(), force=True, trigger="final")
    ckpt.save(2, tiny_state(), force=True, trigger="final")
    jrz.truncate_shard(str(tmp_path), 1)
    with pytest.raises(OSError, match="manifest says"):
        ckpt.verify_manifest(1)
    jrz.corrupt_shard(str(tmp_path), 2)
    assert ckpt.verify_manifest(2) is True  # size-preserving: the shard's CRC catches it
    with pytest.raises(rz.RetryExhausted, match="CRC"):  # the read retries, then gives up
        ckpt.restore(tiny_state(), step=2)


def test_manifest_lists_every_shard_and_is_written_last(tmp_path, ckpts):
    ckpt = ckpts(tmp_path)
    state = tiny_state()
    seen = {}
    ckpt.save_hooks.append(lambda stage, step: seen.setdefault(stage, sorted(
        os.listdir(tmp_path / ".pending" / str(step)))))
    state.step = 2
    assert ckpt.save(2, state, force=True)
    ckpt.wait()
    manifest = json.loads(tio.read_payload(str(tmp_path / "2" / "MANIFEST.dtf")))
    names = [n for n, _ in tstep.state_leaves(state)]
    assert manifest["step"] == 2
    assert [f["path"] for f in manifest["files"]] == [f"shard-{i:05d}.dtf"
                                                      for i in range(len(names))]
    assert [e["name"] for e in manifest["leaves"]] == names
    assert seen["async_begin"] == [] and "MANIFEST.dtf" not in seen["shards_done"]
    assert len(seen["shards_done"]) == len(names)


# -- semantics -----------------------------------------------------------------


def test_back_to_back_async_saves_race_retention(tmp_path, ckpts):
    ckpt = ckpts(tmp_path, max_to_keep=2, save_interval_steps=2)
    state = tiny_state()
    release = threading.Event()
    ckpt.save_hooks.append(rz.FaultPlan((rz.SlowWriter(0, delay_s=10.0),)).save_hook(
        sleep=lambda s: release.wait(30)))
    for s in (2, 4, 6):
        state.step = s
        assert ckpt.save(s, state, force=True)
    assert not (tmp_path / "2").exists()  # stalled: staged, not published
    release.set()
    ckpt.wait()
    assert _digits(tmp_path) == [4, 6]
    assert not os.listdir(tmp_path / ".pending")
    assert not (tmp_path / ".corrupt").exists()
    assert ckpt.verify_manifest(4) is True and ckpt.latest_step() == 6


def test_commit_window_is_invisible_until_publish(tmp_path, ckpts):
    ckpt = ckpts(tmp_path)
    seen = {}

    def probe(stage, step):
        if stage == "shards_done":
            names = os.listdir(tmp_path / ".pending" / str(step))
            seen.update(shards=len(names), manifest="MANIFEST.dtf" in names,
                        published=(tmp_path / str(step)).exists(),
                        latest=tck.Checkpointer.latest_step(ckpt))

    ckpt.save_hooks.append(probe)
    assert ckpt.save(2, tiny_state(), force=True)
    ckpt.wait()
    assert seen == {"shards": len(tstep.state_leaves(tiny_state())), "manifest": False,
                    "published": False, "latest": None}
    assert ckpt.verify_manifest(2) is True


def test_failed_background_commit_poisons_next_save(tmp_path, ckpts):
    ckpt = ckpts(tmp_path)
    state = tiny_state()
    armed = [True]

    def explode(stage, step):
        if stage == "shards_done" and armed[0]:
            armed[0] = False
            raise OSError("disk gone mid-commit")

    ckpt.save_hooks.append(explode)
    assert ckpt.save(2, state, force=True)
    with ckpt._async_cv:  # the commit has failed, its error not yet surfaced
        ckpt._async_cv.wait_for(lambda: not ckpt._async_steps, timeout=30)
    with pytest.raises(rz.RetryExhausted, match="disk gone"):
        ckpt.save(4, state, force=True)  # the next save boundary raises it
    ckpt.wait()  # raised once, not again
    assert not (tmp_path / "2").exists() and not os.listdir(tmp_path / ".pending")
    assert ckpt.save(4, state, force=True)
    ckpt.wait()
    assert ckpt.latest_step() == 4


@pytest.mark.parametrize("where", ["parameter", "adam_moment", "buffer"])
def test_validate_before_save_refuses_a_nonfinite_state(tmp_path, ckpts, where):
    state = tiny_state()
    step = tiny_step(state)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in tiny_batch(1).items()})
    with torch.no_grad():
        if where == "parameter":
            state.model.w[0, 0] = float("nan")
        elif where == "adam_moment":
            state.optimizer.opt.state[state.model.b]["exp_avg_sq"][1] = float("inf")
        else:
            state.model.running_mean[3] = float("nan")
    ckpt = ckpts(tmp_path)
    assert ckpt.save(1, state, force=True) is False
    assert ckpt.save(1, state, force=True, trigger="final") is False
    ckpt.wait()
    assert _digits(tmp_path) == []


def test_snapshot_is_the_step_boundary_state_under_a_delayed_commit(tmp_path, ckpts):
    """The in-place trap: step 2's async commit is held until step 4 has
    run (its updates land in the same parameter and moment tensors); the
    restored step 2 must still be bitwise the state at step 2's end."""
    ckpt = ckpts(tmp_path, save_interval_steps=2)
    release, at_step2, resumed_at = threading.Event(), {}, []
    ckpt.save_hooks.append(rz.FaultPlan((rz.SlowWriter(2, delay_s=10.0),)).save_hook(
        sleep=lambda s: (release.wait(30), resumed_at.append(trainer.state.step))))

    class Watch(tcb.Callback):
        def on_step_end(self, trainer, step, metrics):
            if step == 2:
                at_step2.update(leaves_np(trainer.state))
            if step == 4:
                release.set()

    state = tiny_state()
    trainer = Trainer(tiny_step(state), state,
                      callbacks=[Watch(), tcb.CheckpointCallback(ckpt)])
    trainer.fit(tiny_batches(0), num_steps=4)
    assert resumed_at == [4]
    assert _digits(tmp_path) == [1, 2, 4]
    restored = ckpt.restore(tiny_state(seed=9), step=2)
    _assert_leaves_equal(leaves_np(restored), at_step2)
    assert not np.array_equal(at_step2["model/w"], leaves_np(trainer.state)["model/w"])


class _Boom(tcb.Callback):
    def on_step_end(self, trainer, step, metrics):
        if step == 3:
            raise RuntimeError("a callback failed")


@pytest.mark.parametrize("fault", ["callback", "data"])
def test_emergency_save_keeps_the_last_completed_step(tmp_path, ckpts, fault):
    ckpt = ckpts(tmp_path, save_interval_steps=100)
    state = tiny_state()
    data = tiny_batches(0)
    cbs = [tcb.CheckpointCallback(ckpt)]
    if fault == "callback":
        cbs.insert(0, _Boom())
    else:
        data = rz.FaultPlan((rz.DataError(4),)).wrap(data)
    trainer = Trainer(tiny_step(state), state, callbacks=cbs)
    with pytest.raises((RuntimeError, OSError)):
        trainer.fit(data, num_steps=10)
    want = leaves_np(trainer.state)
    assert trainer.failed and trainer.state.step == 3
    assert _digits(tmp_path) == [1, 3]  # the first-opportunity save, then the emergency one
    _assert_leaves_equal(leaves_np(ckpt.restore(tiny_state(seed=9))), want)


@pytest.mark.parametrize("where", ["optimizer", "buffer_forward"])
def test_emergency_save_is_refused_for_a_fault_inside_the_update(tmp_path, ckpts, monkeypatch,
                                                                 where):
    """A step that raises after its first in-place write leaves a torn
    state: the emergency save must not write it."""
    ckpt = ckpts(tmp_path, save_interval_steps=100)
    state = tiny_state()
    if where == "optimizer":
        real = state.optimizer.opt.step

        def half_then_raise():
            if state.optimizer.count == 2:  # step 3: update w, then fail
                with torch.no_grad():
                    state.model.w.add_(1.0)
                raise RuntimeError("optimizer failed mid-update")
            return real()

        monkeypatch.setattr(state.optimizer.opt, "step", half_then_raise)
    else:
        real_fwd = state.model.forward

        def fwd_then_raise(x):
            out = real_fwd(x)  # the running statistics moved
            if state.step == 2:
                raise RuntimeError("backward failed after the forward's buffer update")
            return out

        monkeypatch.setattr(state.model, "forward", fwd_then_raise)
    rec = flightrec.default_recorder()
    rec.clear()
    trainer = Trainer(tiny_step(state), state, callbacks=[tcb.CheckpointCallback(ckpt)])
    with pytest.raises(RuntimeError):
        trainer.fit(tiny_batches(0), num_steps=10)
    assert trainer.state.updating and trainer.failed
    assert _digits(tmp_path) == [1]
    events = [e for e in rec.events() if e["kind"] == "emergency_checkpoint"]
    assert len(events) == 1 and events[0]["saved"] is False


def test_bf16_leaves_round_trip_as_their_bits(tmp_path, ckpts):
    state = tiny_state()
    state.model.to(torch.bfloat16)
    state.model.w.data.copy_(torch.randn(8, 4, generator=torch.Generator().manual_seed(3)))
    want = leaves_np(state)
    ckpt = ckpts(tmp_path, async_save=False)
    assert ckpt.save(1, state, force=True, trigger="final")
    manifest = json.loads(tio.read_payload(str(tmp_path / "1" / "MANIFEST.dtf")))
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["model/w"] == dtypes["model/running_mean"] == "bfloat16"
    shard = [f["path"] for f, e in zip(manifest["files"], manifest["leaves"])
             if e["name"] == "model/w"][0]
    arr = np.load(__import__("io").BytesIO(tio.read_payload(str(tmp_path / "1" / shard))))
    assert arr.dtype == np.uint16
    target = tiny_state(seed=5)
    target.model.to(torch.bfloat16)
    _assert_leaves_equal(leaves_np(ckpt.restore(target)), want)


def test_restore_refuses_a_step_without_the_ports_layout(tmp_path, ckpts):
    ckpt = ckpts(tmp_path)
    os.makedirs(tmp_path / "5" / "default")
    with pytest.raises(OSError, match="shard-00000.dtf"):
        ckpt.restore(tiny_state())


def test_restore_stays_on_the_states_tensors(tmp_path, ckpts):
    state = tiny_state()
    step = tiny_step(state)
    for i in range(1, 3):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in tiny_batch(i).items()})
    ckpt = ckpts(tmp_path, async_save=False)
    ckpt.save(2, state, force=True, trigger="final")
    target = tiny_state(seed=4)
    ptrs = {n: p.data_ptr() for n, p in target.model.named_parameters()}
    restored = ckpt.restore(target)
    assert restored is target and target.step == 2 and target.optimizer.count == 2
    assert {n: p.data_ptr() for n, p in target.model.named_parameters()} == ptrs
    _assert_leaves_equal(leaves_np(target), leaves_np(state))


def test_preemption_watcher_close_puts_the_handler_back():
    before = signal.getsignal(signal.SIGTERM)
    outer = tck.PreemptionWatcher()
    inner = tck.PreemptionWatcher()
    assert signal.getsignal(signal.SIGTERM) == inner._handler
    outer.close()  # a newer watcher's handler stays
    assert signal.getsignal(signal.SIGTERM) == inner._handler
    inner.close()
    assert signal.getsignal(signal.SIGTERM) == outer._handler
    outer.close()
    assert signal.getsignal(signal.SIGTERM) == before


# -- training parity -------------------------------------------------------------

GPT = ["--data.global_batch_size=8", "--train.eval_batches=0",
       "--checkpoint.save_on_preemption=false"]


def _jax_initial_params(overrides):
    from distributed_tensorflow_tpu.parallel import build_mesh
    from distributed_tensorflow_tpu.utils import config as jconfig
    from distributed_tensorflow_tpu.workloads import gpt_lm as jgpt

    cfg = jconfig.apply_overrides(jgpt.default_config(), overrides)
    parts = jgpt.build(cfg, build_mesh(cfg.mesh))
    params, _ = parts.init_fn(jax.random.PRNGKey(cfg.train.seed))
    return cfg, jax.tree.map(np.asarray, params)


def test_gpt_lm_resume_is_bitwise_and_within_tolerance_of_jax(tmp_path, monkeypatch):
    from test_torch_train_workload import TINY

    from distributed_tensorflow_tpu.workloads import run_workload as j_run
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm
    from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    overrides = TINY + GPT
    jcfg, params = _jax_initial_params(overrides)
    monkeypatch.setattr(ttfm, "init_params",
                        lambda cfg, seed=0, device="cuda", trainable=False:
                        _state_dict_from_jax(params, cfg))

    def run(run_fn, directory, steps, device=None):
        kw = {} if device is None else {"device": device}
        extra = [f"--checkpoint.directory={directory}", "--checkpoint.save_interval_steps=2"]
        return run_fn("gpt_lm", overrides + extra + [f"--train.num_steps={steps}"], **kw)

    straight = run_workload("gpt_lm", overrides + ["--train.num_steps=4"], device="cpu")
    run(run_workload, tmp_path / "port", 2, "cpu")
    resumed = run(run_workload, tmp_path / "port", 4, "cpu")
    run(j_run, tmp_path / "jax", 2)
    j_resumed = run(j_run, tmp_path / "jax", 4)

    assert [h["step"] for h in resumed.history] == [3, 4] == [h["step"]
                                                              for h in j_resumed.history]
    losses = [h["loss"] for h in resumed.history]
    assert losses == [h["loss"] for h in straight.history][2:]
    np.testing.assert_allclose(losses, [h["loss"] for h in j_resumed.history], rtol=1e-5,
                               atol=1e-5)
    _assert_leaves_equal(leaves_np(resumed.state), leaves_np(straight.state))


@pytest.mark.parametrize("name", ["adamw", "momentum"])
def test_optimizer_state_from_jax_continues_like_jax(name):
    """A JAX TrainState at step 2 (warmup + cosine, weight decay — adamw's
    decoupled, momentum's coupled L2 on kernels —, clipping) carried into
    the port (adamw's mu / nu / count, momentum's trace) continues 2 steps
    as JAX's steps 3-4."""
    import test_torch_train_step as T

    from distributed_tensorflow_tpu.train import optimizers as jopt
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.weights import (
        _state_dict_from_jax,
        from_jax_params,
        optimizer_state_from_jax,
    )

    jcfg = H.jax_cfg()
    ocfg = dict(name=name, learning_rate=1e-3 if name == "adamw" else 1e-2, weight_decay=0.1,
                warmup_steps=1, schedule="cosine", total_steps=10, clip_grad_norm=1.0)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    loss_fn = T._jax_loss_fn(jcfg, False)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, {}, b, jax.random.PRNGKey(0))[0]))
    jp = jax.tree.map(jnp.asarray, H.params_np(jcfg, seed=1))
    opt_state = tx.init(jp)
    j_losses = []
    for i in range(4):
        if i == 2:  # the JAX TrainState at step 2, as numpy
            carried = jax.device_get((jp, opt_state))
        loss, g = loss_grad(jp, T._batch(10 + i))
        j_losses.append(float(loss))
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)

    params_np, opt_np = carried
    model = from_jax_params(params_np, H.port_cfg(jcfg, attention_impl="dense"), device="cpu",
                            trainable=True)
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    optimizer_state_from_jax(opt_np, model, opt)
    assert opt.count == 2
    state = tstep.init_train_state(model, opt)
    state.step = 2
    step = tstep.make_train_step(ttfm.lm_loss_fn(model))
    losses = []
    for i in (2, 3):
        state, m = step(state, T._tbatch(T._batch(10 + i)))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, j_losses[2:], rtol=1e-5, atol=1e-5)
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    for name, p in model.named_parameters():
        if not name.endswith("attn.key.bias"):  # its exact gradient is 0 (see T)
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                       err_msg=name)
