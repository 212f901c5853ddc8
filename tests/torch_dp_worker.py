"""One rank of a data-parallel job of the PyTorch port, for the tests and
``chip_smoke.py`` (imports torch and the port, never jax).

Run as ``python tests/torch_dp_worker.py <spec.json>`` once per rank, with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as
``torchrun`` sets them. On the card, with ``"backend": "gloo"`` in the
spec every rank runs on card 0 over gloo, else each on its own card.
Each rank writes ``rank<r>.npz`` into the spec's ``out`` directory and
exits non-zero on any failure. The spec's ``job``:

- ``"resnet"``: for each ``(block_impl, DTF_FUSED_BWD[, dtype])`` of
  ``impls`` (its tag: the entry joined by "/"), a ResNet of ``cfg`` built
  from the state dict in ``inputs`` (``sd/<name>``) with sync BN over the
  mesh, stepped once on this rank's rows of each global batch
  ``image<i>``/``label<i>`` in turn; it saves each pass's
  losses, its parameters and buffers after the steps and the conv+BN
  launches of its steps. With ``runner``: also ``run_workload(
  "resnet50_imagenet", runner)`` (the runner's cluster, mesh, Prefetcher
  and replicated weights) and the check that every rank ends with the same
  weights. With ``eval``: the ``ShardedEvaluator`` on the first impl's
  model from ``sd`` over the global batches, and one process evaluating
  every rank's rows in rank order (``eval_both``).
- ``"bert"``: a Transformer of ``cfg`` (the port's config fields) built
  from ``sd`` in ``inputs``, stepped with adamw (``optimizer``) on this
  rank's rows of each global batch ``train<i>/<key>`` (``bert_steps``); it
  saves the losses and the parameters after the steps, then evaluates the
  global batches ``eval<i>/<key>`` with ``mlm_eval_fn`` both ways
  (``eval_both``). With ``dropout``: the same steps again from ``sd`` at
  that dropout rate (``dropout/losses``, ``dropout/state/<name>``).
- ``"parallel"``: the collectives, the differentiable all-reduce, the
  megatron pair and ``gather_fsdp`` (on a model=2 and an fsdp=2 mesh of
  the two ranks), sequence parallelism's verbs (on a seq=2 mesh, native
  and emulated), the divergence check, ``broadcast_from_chief``,
  ``replicate`` and the refusals (an expert spec, the mesh's, the
  collectives'), each result saved for the test to hold against numpy.
- ``"ckpt"``: ``run_workload(workload, overrides)`` (its
  ``--checkpoint.directory`` among them) once per entry of ``runs``, each
  ``{"num_steps", "sigterm": {rank: step}, "kill_at": step}``: a
  ``Sigterm`` fault on the ranks named, and an ``AsyncCommitKill`` in the
  checkpoint writer (the process dies by SIGKILL, shards written,
  nothing published). Each run saves its history's steps and losses,
  whether it stopped on a preemption save, the state it started from
  (after the restore), the state it ended with, and how many checkpoint
  commits this process made (``ckpt_save`` events: only the chief
  writes).
- ``"ckpt_fallback"``: a tiny ResNet of ``cfg`` saved at steps 2 and 4
  into ``dir``, step 4's ``shard-00000.dtf`` truncated by the chief, then
  a fresh ``Checkpointer``'s ``init_or_restore(fallback=True)`` and a
  forced ``save(4, trigger="final")``; it saves the restored step, what
  the save returned, the steps the checkpointer knows and whether step
  4's manifest verifies after a barrier.

- ``"wide_deep"``: on the mesh of ``mesh`` (e.g. ``{"data": 2,
  "model": 2}``, the tables range-sharded over ``model``): with
  ``lookups``, the npz's ``ids``/``table``/``cot`` through
  ``mod_sharded_lookup``, ``range_sharded_lookup`` (ids: this rank's
  data shard's rows) and ``batch_sharded_lookup`` (ids: this rank's rows
  over data x model), each rank's output and its table shard's gradient of
  ``sum(out * cot)`` summed over ``data``; with ``inputs``
  (``sd/<name>`` a whole state dict, ``train<i>/<key>`` and
  ``eval<i>/<key>`` global batches), ``wide_deep_steps`` of ``cfg`` with
  the ``auto`` optimizer at ``optimizer`` and the ``ShardedEvaluator``'s
  totals over the eval batches, and with ``clip`` (``optimizer`` and
  step ``options``) the same steps clipped, with their ``grad_norm``s;
  with ``runner``, ``run_workload("wide_deep", runner)``'s losses, this
  rank's parameters and its eval (with a ``--checkpoint.directory`` among
  them, the same run again, resumed from its save: ``runner/resumed/``);
  with ``fsdp_mesh`` (e.g. ``{"data": 1, "fsdp": 2, "model": 2}``), the
  same steps on that mesh (``fsdp/``: the batch split over fsdp, the
  tables over model); with ``refuse`` (workload -> overrides), the message
  each such ``run_workload`` raises.

- ``"gpt"``: a causal Transformer of ``cfg`` built from ``sd`` in
  ``inputs``, stepped with ``optimizer`` and the chunked LM loss
  (``chunk``) on this rank's rows of each global batch
  ``train<i>/input_ids`` (``bert_steps``), at dropout 0 (``plain/``) and
  at ``dropout`` with remat (``dropout/``): the losses and the state dict
  after the steps. With ``runner``: also ``run_workload("gpt_lm",
  runner)``'s losses, data axis and final weights.

- ``"cnn"``: a CIFAR-10 CNN of ``cfg`` over ``input_shape`` images built
  from ``sd`` in ``inputs``, stepped with momentum 0.9 at 0.05 and a
  cosine decay over the batches (``cnn_steps``) on this rank's rows of
  each global batch ``image<i>``/``label<i>`` (sync BatchNorm over the
  mesh); it saves the losses and the state dict after the steps. With
  ``runner``: also ``run_workload("cifar10_cnn", runner)``'s losses and
  mesh, and the check that every rank ends with the same weights. With
  ``fsdp_runs`` (workload -> overrides): each ``run_workload`` at
  ``mesh.data=2`` and again at ``data=1, fsdp=2`` (``<workload>/data2/``,
  ``<workload>/fsdp2/``: losses, mesh, state dict).

- ``"tp"``: tensor and fully-sharded data parallelism: each of ``cases``
  (a Transformer config, a mesh such as ``{"fsdp": 2, "model": 2}``, an
  optimizer, step options, the chunked LM or the MLM loss) stepped on
  its global batches (``tp_steps``: losses, norms, the replicated
  parameters' drift across ranks after each step, the state gathered
  whole, the evaluator's totals, a save and its restore at the mesh),
  and with ``runner`` each workload's ``run_workload`` at its mesh.

- ``"seq"``: sequence parallelism: for each of ``attention`` (a tag and a
  mesh such as ``{"seq": 2, "model": 2}``), ``sequence_parallel_attention``
  of every schedule, causal or not, with the npz's ``<tag>/mask`` or none
  (or the ``runs`` given, ``[impl, causal, masked]``, in ``dtype``), on
  this rank's batch rows and heads of ``<tag>/q``, ``k``, ``v`` (the whole
  sequence): the output, the gradients of ``sum(out * cot)`` and the
  flash launches of the call (forward, dK/dV, dQ);
  with ``emulated``, the ring again, causal and masked and neither, with
  the permute emulated by all-reduces (as under gloo on CUDA tensors). Then
  ``cases`` and ``runner`` as the ``tp`` job runs them.

- ``"pipe"``: pipeline parallelism: for each of ``apply`` (a tag, a mesh
  such as ``{"pipe": 2, "data": 2}`` and ``virtual``), ``pipeline_apply``
  of the toy stage ``tanh(x @ w + b)`` on the npz's stacked ``<tag>/w``,
  ``<tag>/b`` and this rank's rows of ``<tag>/x`` (``[M, mb, d]``): the
  output and the gradients of ``sum(out ** 2)`` summed over the ranks
  (``dw``, ``db``); for each of ``forward`` (a tag, a mesh, a config,
  ``virtual``, ``microbatches``, the npz's ``sd_<tag>/`` state dict and
  ``<tag>/ids``, ``mask``, ``positions``), a ``PipelinedTransformer``'s
  logits of this rank's rows and the gradients of the mean of the
  squared global logits, each of its parameters' summed over the batch
  shards and gathered over ``model`` (``grad/<name>``). Then ``cases``
  (``tp_steps`` with a ``pipeline``: ``{"virtual", "microbatches"}``; a
  ``restore`` names the step dir of an earlier case, restored before the
  case's steps) and ``runner`` as the ``tp`` job runs them.

``train_steps``, ``bert_steps``, ``wide_deep_steps``, ``cnn_steps`` and
``tp_steps`` are also what the one-process references run (no mesh);
``launch`` starts the ranks of a spec, ``wait`` collects them and
``stop`` kills them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from distributed_tensorflow_tpu_torch.models import common, resnet  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import cluster  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.sharding import (  # noqa: E402
    StageSpec,
    check_spec,
    match_partition_rules,
    shard_host_batch,
)
from distributed_tensorflow_tpu_torch.train import optimizers as topt  # noqa: E402
from distributed_tensorflow_tpu_torch.train import step as tstep  # noqa: E402

#: picks the fused blocks' backward (ops/_policy.py)
ENV_BWD = "DTF_FUSED_BWD"
#: the optimizer of every pass: resnet50_imagenet's (momentum, coupled L2)
OPTIMIZER = dict(name="momentum", learning_rate=0.1, momentum=0.9, weight_decay=1e-4)


def train_steps(cfg: resnet.ResNetConfig, sd: dict, batches: list[dict], device, mesh=None,
                bwd: str = "xla", label_smoothing: float = 0.1) -> dict:
    """``len(batches)`` momentum steps of a ResNet of ``cfg`` from state dict
    ``sd`` on ``device``: with ``mesh``, each batch is the global batch and
    this rank steps on its rows. Returns the losses, the state dict after
    the steps (numpy) and the conv+BN kernels' launches during the steps."""
    old = os.environ.get(ENV_BWD)
    os.environ[ENV_BWD] = bwd
    try:
        model = resnet.build(cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, device, mesh)
        opt = topt.make_optimizer(topt.OptimizerConfig(**OPTIMIZER), model.parameters())
        state = tstep.init_train_state(model, opt)
        step = tstep.make_train_step(
            common.classification_loss_fn(model, label_smoothing=label_smoothing), mesh=mesh)
        for k in fcb.KERNELS.values():
            k.launches = 0
        losses = []
        for b in batches:
            rows = shard_host_batch(b, mesh) if mesh is not None else b
            state, m = step(state, {k: torch.as_tensor(v).to(device) for k, v in rows.items()})
            losses.append(float(m["loss"]))
        launches = {n: k.launches for n, k in fcb.KERNELS.items()}
    finally:
        if old is None:
            os.environ.pop(ENV_BWD, None)
        else:
            os.environ[ENV_BWD] = old
    out = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    return {"losses": np.asarray(losses), "state": out, "launches": launches}


def load_inputs(path: str) -> tuple[dict, list[dict]]:
    """(state dict, global batches) from an npz of ``sd/<name>`` and
    ``image<i>``/``label<i>`` arrays."""
    data = np.load(path)
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    batches = [{"image": data[f"image{i}"], "label": data[f"label{i}"]}
               for i in range(sum(k.startswith("image") for k in data.files))]
    return sd, batches


def job_resnet(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.utils.multihost import assert_same_across_hosts

    cfg = resnet.ResNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in spec["cfg"].items()})
    sd, batches = load_inputs(spec["inputs"])
    out = {}
    for entry in spec["impls"]:
        impl, bwd, *dtype = entry
        run_cfg = dataclasses.replace(cfg, block_impl=impl, dtype=dtype[0] if dtype else cfg.dtype)
        res = train_steps(run_cfg, sd, batches, dev, mesh, bwd=bwd,
                          label_smoothing=spec.get("label_smoothing", 0.1))
        tag = "/".join(entry)
        out[f"{tag}/losses"] = res["losses"]
        out.update({f"{tag}/state/{k}": v for k, v in res["state"].items()})
        out.update({f"{tag}/launches/{k}": np.asarray(v) for k, v in res["launches"].items()})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if spec.get("runner"):
        from distributed_tensorflow_tpu_torch.workloads import run_workload

        res = run_workload("resnet50_imagenet", spec["runner"], device=dev.type)
        assert_same_across_hosts(
            {k: v.detach().cpu() for k, v in res.state.model.state_dict().items()},
            "weights after run_workload")
        out["runner/losses"] = np.asarray([r["loss"] for r in res.history])
        out["runner/mesh_data"] = np.asarray(res.mesh.shape["data"])
    if spec.get("eval"):
        impl, _, *dtype = spec["impls"][0]
        run_cfg = dataclasses.replace(cfg, block_impl=impl,
                                      dtype=dtype[0] if dtype else cfg.dtype)
        model = resnet.build(run_cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, dev, mesh)
        out.update(eval_both(model, common.classification_eval_fn(model), batches, dev, mesh))
    return out


def eval_both(model, eval_fn, batches: list[dict], device, mesh) -> dict:
    """``ShardedEvaluator`` totals over this rank's rows of each global
    batch (``eval/sharded/<key>``), and one process evaluating every rank's
    rows of each batch in rank order with the float64 host sums of the
    serial evaluator (``eval/serial/<key>``)."""
    from distributed_tensorflow_tpu_torch.obs.registry import Registry
    from distributed_tensorflow_tpu_torch.parallel.sharding import put_host_batch
    from distributed_tensorflow_tpu_torch.train.evaluation import ShardedEvaluator

    state = tstep.TrainState(step=0, model=model, optimizer=None, generator=None)
    evaluator = ShardedEvaluator(eval_fn, mesh, registry=Registry())
    sharded = evaluator.run(state, [shard_host_batch(b, mesh) for b in batches])
    world = evaluator.shards
    serial: dict = {}
    model.eval()
    for b in batches:
        per = len(next(iter(b.values()))) // world
        for r in range(world):
            chunk = put_host_batch({k: v[r * per:(r + 1) * per] for k, v in b.items()}, device)
            with torch.no_grad():
                for k, v in eval_fn(chunk).items():
                    serial[k] = serial.get(k, 0.0) + np.asarray(v.cpu().numpy(), np.float64)
    return {**{f"eval/sharded/{k}": np.asarray(v) for k, v in sharded.items()},
            **{f"eval/serial/{k}": np.asarray(v) for k, v in serial.items()}}


def job_bert(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm

    data = np.load(spec["inputs"])
    sd = {k[3:]: torch.as_tensor(data[k]) for k in data.files if k.startswith("sd/")}

    def batches(prefix):
        n = len({k.split("/")[0] for k in data.files if k.startswith(prefix)})
        return [{k.split("/")[1]: data[k] for k in data.files if k.startswith(f"{prefix}{i}/")}
                for i in range(n)]

    cfg = ttfm.TransformerConfig(**spec["cfg"])
    res = bert_steps(cfg, sd, batches("train"), spec["optimizer"], dev, mesh)
    out = {"losses": res["losses"], **{f"state/{k}": v for k, v in res["state"].items()}}
    out.update(eval_both(res["model"], ttfm.mlm_eval_fn(res["model"]), batches("eval"), dev,
                         mesh))
    if spec.get("dropout"):
        res = bert_steps(dataclasses.replace(cfg, dropout=spec["dropout"]), sd,
                         batches("train"), spec["optimizer"], dev, mesh)
        out["dropout/losses"] = res["losses"]
        out.update({f"dropout/state/{k}": v for k, v in res["state"].items()})
    return out


def bert_steps(cfg, sd: dict, batches: list[dict], optimizer: dict, device, mesh=None,
               lm_chunk: int | None = None) -> dict:
    """``len(batches)`` steps of a Transformer of ``cfg`` from state dict
    ``sd`` with ``optimizer`` and ``mlm_loss_fn`` (with ``lm_chunk``: the
    causal LM loss, chunked at that size when above 0) on ``device``: with
    ``mesh``, each batch is the global batch and this rank steps on its
    rows. Returns the losses, the state dict after the steps (numpy) and
    the model."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm

    model = ttfm.build(cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, device,
                       trainable=True)
    opt = topt.make_optimizer(topt.OptimizerConfig(**optimizer), model.parameters())
    state = tstep.init_train_state(model, opt)
    loss_fn = (ttfm.mlm_loss_fn(model) if lm_chunk is None
               else ttfm.causal_lm_loss(model, lm_chunk))
    step = tstep.make_train_step(loss_fn, mesh=mesh)
    losses = []
    for b in batches:
        rows = shard_host_batch(b, mesh) if mesh is not None else b
        state, m = step(state, {k: torch.as_tensor(v).to(device) for k, v in rows.items()})
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses), "model": model,
            "state": {k: v.detach().float().cpu().numpy()
                      for k, v in model.state_dict().items()}}


def job_parallel(spec: dict, dev, mesh) -> dict:
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel import collectives as col
    from distributed_tensorflow_tpu_torch.parallel.sharding import local_rows, replicate
    from distributed_tensorflow_tpu_torch.utils import multihost

    r = dist.get_rank()
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) * (r + 1) + r
    out = {
        "x": x.clone().numpy(),
        "sum": col.all_reduce(x, "data", mesh).numpy(),
        "sum_batch_axes": col.all_reduce(x, ("data", "fsdp"), mesh).numpy(),
        "mean": col.all_reduce_mean(x, "data", mesh).numpy(),
        "gather0": col.all_gather(x, "data", mesh, tiled_axis=0).numpy(),
        "gather1": col.all_gather(x, "data", mesh, tiled_axis=1).numpy(),
        "scatter0": col.reduce_scatter(x, "data", mesh, scatter_axis=0).numpy(),
        "scatter1": col.reduce_scatter(x, "data", mesh, scatter_axis=1).numpy(),
        "bcast1": col.broadcast(x, "data", mesh, src=1).numpy(),
        "model_identity": col.all_reduce(x, "model", mesh).numpy(),
        "barrier": np.asarray(col.barrier("data", mesh)),
        "index": np.asarray(col.axis_index("data", mesh)),
        "size": np.asarray(col.axis_size(("data", "fsdp"), mesh)),
        "rows": np.asarray([local_rows(8, mesh).start, local_rows(8, mesh).stop]),
        "dim_names": np.asarray(mesh.device_mesh.mesh_dim_names),
    }
    out["x_after"] = x.numpy()  # every verb left its input as it was
    # the all-reduce's backward sums the cotangent: d/dx of sum(c_r *
    # all_reduce(x)) on rank r is c_0 + c_1
    xg = x.clone().requires_grad_(True)
    c = torch.full((2, 4), float(r + 1)) + torch.arange(4.0)
    (col.all_reduce(xg, "data", mesh) * c).sum().backward()
    out["grad"], out["c"] = xg.grad.numpy(), c.numpy()
    # reduce_scatter's backward is the all-gather of the cotangents
    xs = x.clone().requires_grad_(True)
    (col.reduce_scatter(xs, "data", mesh, scatter_axis=0) * (r + 1)).sum().backward()
    out["scatter_grad"] = xs.grad.numpy()
    multihost.assert_same_across_hosts({"step": 3, "loss": torch.tensor(1.5)}, "same")
    try:
        multihost.assert_same_across_hosts({"step": 3 + r}, "step")
        out["divergence_caught"] = np.asarray(False)
    except AssertionError as e:
        out["divergence_caught"] = np.asarray("Cross-host divergence on 'step'" in str(e))
    out["chief_run_id"] = np.asarray(multihost.broadcast_from_chief({"run": f"run-{r}"})["run"])
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r + 5))
        lin.bias.fill_(float(-r))
    replicate(lin, mesh)
    out["replicated"] = torch.cat([lin.weight.flatten(), lin.bias]).detach().numpy()
    # the megatron pair and the fsdp gather, on a model=2 and an fsdp=2 mesh
    # of the same two ranks
    for axis in ("model", "fsdp"):
        m2 = build_mesh(MeshSpec(data=1, **{axis: 2}), dev)
        xg = x.clone().requires_grad_(True)
        if axis == "model":
            y = col.reduce_from_model(xg, m2)
            (y * c).sum().backward()
            out["reduce_from_model"], out["reduce_from_model_grad"] = y.detach().numpy(), \
                xg.grad.numpy()
            xg = x.clone().requires_grad_(True)
            (col.copy_to_model(xg, m2) * c).sum().backward()
            out["copy_to_model_grad"] = xg.grad.numpy()
            out["max"] = col.all_reduce_max(x, "model", m2).numpy()
            out["min"] = col.all_reduce_min(x, "model", m2).numpy()
        else:
            y = col.gather_fsdp(xg, 1, m2)
            (y * torch.arange(16.0).reshape(2, 8)).sum().backward()
            out["gather_fsdp"], out["gather_fsdp_grad"] = y.detach().numpy(), xg.grad.numpy()
    # sequence parallelism's verbs on a seq=2 mesh of the two ranks, each
    # with the gradient of sum(y * cot); then with the permute emulated by
    # all-reduces (gloo's path on CUDA tensors)
    s2 = build_mesh(MeshSpec(data=1, seq=2), dev)
    verbs = {"permute": lambda t: col.ring_permute(t, "seq", s2),
             "permute_back": lambda t: col.ring_permute(t, "seq", s2, shift=-1),
             "a2a": lambda t: col.all_to_all(t, "seq", s2, split_axis=1, concat_axis=0),
             "scatter": lambda t: col.scatter_to_axis(t, 1, "seq", s2),
             "gather": lambda t: col.gather_from_axis(t, 0, "seq", s2),
             "all_gather": lambda t: col.all_gather(t, "seq", s2, tiled_axis=1)}
    for emulated in (False, True):
        native = col._native_p2p
        if emulated:
            col._native_p2p = lambda group, t: False
        try:
            for name, verb in verbs.items():
                xg = x.clone().requires_grad_(True)
                y = verb(xg)
                cot = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * (r + 1)
                (y * cot).sum().backward()
                tag = f"sp/{'emulated/' if emulated else ''}{name}"
                out[tag], out[f"{tag}_grad"] = y.detach().numpy(), xg.grad.numpy()
        finally:
            col._native_p2p = native
    refusals = []
    for call in (lambda: check_spec(("expert", None), "kernel"),
                 lambda: build_mesh(MeshSpec(data=1, expert=2), dev),
                 lambda: col.all_reduce(x, "data", mesh, groups=[[0, 1]]),
                 lambda: col.all_to_all(x, "data", mesh, split_axis=0, concat_axis=1,
                                        groups=[[0, 1]]),
                 lambda: build_mesh(MeshSpec(data=1, pipe=2, dcn_pipe=2), dev)):
        try:
            call()
            refusals.append("no error")
        except NotImplementedError as e:
            refusals.append(str(e))
    out["refusals"] = np.asarray(refusals)
    cluster.sync_hosts("end")
    return out


def job_ckpt(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch import resilience as rz
    from distributed_tensorflow_tpu_torch.obs import flightrec
    from distributed_tensorflow_tpu_torch.train import callbacks as tcb
    from distributed_tensorflow_tpu_torch.train import step as tstep
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    rank = cluster.process_index()

    def flat(state) -> dict:
        return {name: t.detach().float().cpu().clone().numpy()
                for name, t in tstep.state_leaves(state)}

    class Record(tcb.Callback):
        """The state the run starts from, and the kill hook in the writer."""

        def __init__(self, tag, kill_at):
            self.tag, self.kill_at = tag, kill_at

        def on_train_start(self, trainer):
            out.update({f"{self.tag}/start/{k}": v for k, v in flat(trainer.state).items()})
            if self.kill_at is not None:
                trainer.emergency_checkpoint.save_hooks.append(
                    rz.FaultPlan((rz.AsyncCommitKill(self.kill_at),)).save_hook())

    out = {}
    for r, run in enumerate(spec["runs"]):
        tag = f"run{r}"
        before = sum(e["kind"] == "ckpt_save" for e in flightrec.default_recorder().events())
        extra = [Record(tag, run.get("kill_at"))]
        at = run.get("sigterm", {}).get(str(rank))
        if at is not None:
            extra.append(rz.FaultPlan((rz.Sigterm(at),)).callback())
        res = run_workload(spec["workload"], spec["overrides"] + [
            f"--train.num_steps={run['num_steps']}"], device=dev, extra_callbacks=extra)
        out[f"{tag}/steps"] = np.asarray([h["step"] for h in res.history])
        out[f"{tag}/losses"] = np.asarray([h["loss"] for h in res.history])
        out[f"{tag}/preempted"] = np.asarray(res.preempted)
        out[f"{tag}/commits"] = np.asarray(sum(
            e["kind"] == "ckpt_save" for e in flightrec.default_recorder().events()) - before)
        out.update({f"{tag}/end/{k}": v for k, v in flat(res.state).items()})
    return out


def job_ckpt_fallback(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.train import checkpoint as tck

    cfg = resnet.ResNetConfig(**spec["cfg"])
    model = resnet.build(cfg, resnet.init_params(cfg, seed=0, device=dev), dev, mesh)
    state = tstep.init_train_state(model, topt.make_optimizer(
        topt.OptimizerConfig(**OPTIMIZER), model.parameters()))
    ccfg = tck.CheckpointConfig(directory=spec["dir"], async_save=False,
                                save_on_preemption=False)
    ck = tck.Checkpointer(ccfg)
    try:
        for step in (2, 4):
            state.step = step
            ck.save(step, state, force=True)
    finally:
        ck.close()
    if cluster.is_chief():
        shard = os.path.join(tck.step_dir(spec["dir"], 4), tck._shard_name(0))
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 1)
    cluster.sync_hosts("torn")
    ck = tck.Checkpointer(ccfg)
    try:
        state, restored = tck.init_or_restore(ck, state, fallback=True)
        restored_step = int(state.step)
        saved = ck.save(4, state, force=True, trigger="final")
        cluster.sync_hosts("final_saved")
        verified = ck.verify_manifest(4)
        known = sorted(ck._known)
    finally:
        ck.close()
    return {"restored": np.asarray(restored), "restored_step": np.asarray(restored_step),
            "saved": np.asarray(saved), "known": np.asarray(known),
            "verified": np.asarray(bool(verified))}


def wide_deep_steps(cfg, sd: dict, batches: list[dict], optimizer: dict, device,
                    mesh=None, options: dict | None = None) -> dict:
    """``len(batches)`` steps of a Wide&Deep model of ``cfg`` built from the
    whole state dict ``sd`` (this rank's table shards over ``mesh``'s
    ``model`` axis), the workload's ``auto`` optimizer (FTRL + AdaGrad) at
    ``optimizer`` and the step's ``StepOptions(**options)``: each batch is
    the global batch and this rank steps on its data shard's rows. Returns
    the losses, the ``grad_norm``s when the options compute them, this
    rank's parameters after the steps (numpy) and the model."""
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.workloads.runner import RunConfig
    from distributed_tensorflow_tpu_torch.workloads.wide_deep import _canonical_tx

    model = wd.build(cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, device, mesh)
    opt = _canonical_tx(RunConfig(model=cfg, optimizer=topt.OptimizerConfig(**optimizer)))(model)
    if mesh is not None:
        opt.place(mesh, match_partition_rules(wd.WIDE_DEEP_RULES, model), model)
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(wd.ctr_loss_fn(model), tstep.StepOptions(**(options or {})),
                                 mesh=mesh)
    losses, norms = [], []
    for b in batches:
        rows = shard_host_batch(b, mesh) if mesh is not None else b
        state, m = step(state, {k: torch.as_tensor(v).to(device) for k, v in rows.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m.get("grad_norm", np.nan)))
    out = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    return {"losses": np.asarray(losses), "grad_norms": np.asarray(norms), "state": out,
            "model": model}


def wide_deep_lookups(data, mesh) -> dict:
    """The three sharded lookups of ``ops/embedding.py`` on ``data``'s ids,
    table and cotangent: each output and the table shard's gradient of
    ``sum(out * cot)`` summed over ``data`` (module docstring)."""
    from distributed_tensorflow_tpu_torch.ops import embedding as emb
    from distributed_tensorflow_tpu_torch.parallel import collectives as col
    from distributed_tensorflow_tpu_torch.parallel.mesh import BATCH_AXES

    ids, table, cot = (torch.as_tensor(data[k]) for k in ("ids", "table", "cot"))
    data_rows = shard_host_batch({"i": ids, "c": cot}, mesh)
    n_model, m = mesh.shape["model"], col.axis_index("model", mesh)
    rank = col.axis_index(BATCH_AXES, mesh) * n_model + m
    per = len(ids) // (col.axis_size(BATCH_AXES, mesh) * n_model)
    rank_rows = slice(rank * per, (rank + 1) * per)
    cases = {
        "mod": (emb.mod_sharded_lookup, emb.to_mod_sharded(table, mesh), data_rows["i"],
                data_rows["c"]),
        "range": (emb.range_sharded_lookup, emb.range_shard(table, m, n_model), data_rows["i"],
                  data_rows["c"]),
        "batch": (emb.batch_sharded_lookup, emb.to_mod_sharded(table, mesh), ids[rank_rows],
                  cot[rank_rows]),
    }
    out = {}
    for name, (fn, shard, i, c) in cases.items():
        t = shard.clone().requires_grad_(True)
        y = fn(i, t, mesh)
        (y * c).sum().backward()
        out[f"lookup/{name}/out"] = y.detach().numpy()
        out[f"lookup/{name}/grad"] = col.all_reduce(t.grad, "data", mesh).numpy()
    return out


def job_wide_deep(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.obs.registry import Registry
    from distributed_tensorflow_tpu_torch.train.evaluation import ShardedEvaluator
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    out = {}
    if spec.get("lookups") or spec.get("inputs"):
        mesh = build_mesh(MeshSpec(**spec["mesh"]), dev)
    if spec.get("lookups"):
        out.update(wide_deep_lookups(np.load(spec["lookups"]), mesh))
    if spec.get("inputs"):
        data = np.load(spec["inputs"])
        sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}

        def batches(prefix):
            n = len({k.split("/")[0] for k in data.files if k.startswith(prefix)})
            return [{k.split("/")[1]: data[k] for k in data.files
                     if k.startswith(f"{prefix}{i}/")} for i in range(n)]

        cfg = wd.WideDeepConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in spec["cfg"].items()})
        res = wide_deep_steps(cfg, sd, batches("train"), spec["optimizer"], dev, mesh)
        out["losses"] = res["losses"]
        out.update({f"state/{k}": v for k, v in res["state"].items()})
        state = tstep.TrainState(step=0, model=res["model"], optimizer=None, generator=None)
        totals = ShardedEvaluator(wd.ctr_eval_fn(res["model"]), mesh, registry=Registry()).run(
            state, [shard_host_batch(b, mesh) for b in batches("eval")])
        out.update({f"eval/{k}": np.asarray(v) for k, v in totals.items()})
        if spec.get("fsdp_mesh"):  # the same steps with the batch over fsdp
            fmesh = build_mesh(MeshSpec(**spec["fsdp_mesh"]), dev)
            res = wide_deep_steps(cfg, sd, batches("train"), spec["optimizer"], dev, fmesh)
            out["fsdp/losses"] = res["losses"]
            out.update({f"fsdp/state/{k}": v for k, v in res["state"].items()})
        if spec.get("clip"):  # the same steps, both clips binding
            clip = spec["clip"]
            res = wide_deep_steps(cfg, sd, batches("train"), clip["optimizer"], dev, mesh,
                                  clip["options"])
            out["clip/losses"], out["clip/grad_norms"] = res["losses"], res["grad_norms"]
            out.update({f"clip/state/{k}": v for k, v in res["state"].items()})
    if spec.get("runner"):
        res = run_workload("wide_deep", spec["runner"], device=str(dev))
        out["runner/losses"] = np.asarray([r["loss"] for r in res.history])
        out["runner/mesh_model"] = np.asarray(res.mesh.shape["model"])
        out.update({f"runner/state/{k}": v.detach().float().cpu().numpy()
                    for k, v in res.state.model.state_dict().items()})
        out.update({f"runner/eval/{k}": np.asarray(v)
                    for k, v in (res.eval_metrics or {}).items()})
        if any(a.startswith("--checkpoint.directory") for a in spec["runner"]):
            # the same run again: it resumes at its last step from the save
            res = run_workload("wide_deep", spec["runner"], device=str(dev))
            out["runner/resumed/step"] = np.asarray(res.state.step)
            out.update({f"runner/resumed/state/{k}": v.detach().float().cpu().numpy()
                        for k, v in res.state.model.state_dict().items()})
    for name, over in spec.get("refuse", {}).items():  # workloads that shard nothing
        try:
            run_workload(name, over, device=str(dev))
            out[f"refused/{name}"] = np.asarray("no error")
        except ValueError as e:
            out[f"refused/{name}"] = np.asarray(str(e))
    return out


#: the CNN passes' optimizer: cifar10_cnn's (momentum, cosine over the steps)
CNN_OPTIMIZER = dict(name="momentum", learning_rate=0.05, momentum=0.9, schedule="cosine")


def cnn_steps(cfg, sd: dict, batches: list[dict], device, mesh=None,
              input_shape=(32, 32, 3)) -> dict:
    """``len(batches)`` momentum steps of a CNN of ``cfg`` from state dict
    ``sd`` on ``device``, the cosine decay over those steps: with ``mesh``,
    each batch is the global batch and this rank steps on its rows.
    Returns the losses and the state dict after the steps (numpy)."""
    from distributed_tensorflow_tpu_torch.models import cnn

    model = cnn.build(cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, device,
                      tuple(input_shape), mesh)
    opt = topt.make_optimizer(topt.OptimizerConfig(**CNN_OPTIMIZER, total_steps=len(batches)),
                              model.parameters())
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(common.classification_loss_fn(model), mesh=mesh)
    losses = []
    for b in batches:
        rows = shard_host_batch(b, mesh) if mesh is not None else b
        state, m = step(state, {k: torch.as_tensor(v).to(device) for k, v in rows.items()})
        losses.append(float(m["loss"]))
    out = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    return {"losses": np.asarray(losses), "state": out}


def job_cnn(spec: dict, dev, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.models import cnn
    from distributed_tensorflow_tpu_torch.utils.multihost import assert_same_across_hosts

    cfg = cnn.CNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in spec["cfg"].items()})
    sd, batches = load_inputs(spec["inputs"])
    res = cnn_steps(cfg, sd, batches, dev, mesh, spec["input_shape"])
    out = {"losses": res["losses"], **{f"state/{k}": v for k, v in res["state"].items()}}
    if spec.get("runner"):
        from distributed_tensorflow_tpu_torch.workloads import run_workload

        run = run_workload("cifar10_cnn", spec["runner"], device=dev.type)
        assert_same_across_hosts(
            {k: v.detach().cpu() for k, v in run.state.model.state_dict().items()},
            "weights after run_workload")
        out["runner/losses"] = np.asarray([r["loss"] for r in run.history])
        out["runner/mesh_data"] = np.asarray(run.mesh.shape["data"])
    for name, over in spec.get("fsdp_runs", {}).items():  # fsdp as a batch axis
        from distributed_tensorflow_tpu_torch.workloads import run_workload

        for tag, mesh_over in (("data2", ["--mesh.data=2"]),
                               ("fsdp2", ["--mesh.data=1", "--mesh.fsdp=2"])):
            run = run_workload(name, over + mesh_over, device=dev.type)
            out[f"{name}/{tag}/losses"] = np.asarray([r["loss"] for r in run.history])
            out[f"{name}/{tag}/mesh"] = np.asarray([run.mesh.shape[a] for a in ("data", "fsdp")])
            out.update({f"{name}/{tag}/state/{k}": v.detach().float().cpu().numpy()
                        for k, v in run.state.model.state_dict().items()})
    return out


def job_gpt(spec: dict, dev, mesh) -> dict:
    """A causal Transformer of ``cfg`` from ``sd`` stepped data-parallel
    with the chunked LM loss (``chunk``) on this rank's rows of each
    global batch ``train<i>/input_ids``: plain (``dropout 0``), with
    ``dropout`` and ``remat``, and ``run_workload("gpt_lm", runner)``'s
    losses and final weights."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm

    data = np.load(spec["inputs"])
    sd = {k[3:]: torch.as_tensor(data[k]) for k in data.files if k.startswith("sd/")}
    n = len({k for k in data.files if k.startswith("train")})
    batches = [{"input_ids": data[f"train{i}/input_ids"]} for i in range(n)]
    cfg = ttfm.TransformerConfig(**spec["cfg"])
    out = {}
    for tag, kw in (("plain", {}), ("dropout", {"dropout": spec["dropout"], "remat": True})):
        res = bert_steps(dataclasses.replace(cfg, **kw), sd, batches, spec["optimizer"], dev,
                         mesh, lm_chunk=spec["chunk"])
        out[f"{tag}/losses"] = res["losses"]
        out.update({f"{tag}/state/{k}": v for k, v in res["state"].items()})
    if spec.get("runner"):
        from distributed_tensorflow_tpu_torch.workloads import run_workload

        res = run_workload("gpt_lm", spec["runner"], device=dev)
        out["runner/losses"] = np.asarray([h["loss"] for h in res.history])
        out["runner/data_axis"] = np.asarray(res.mesh.shape["data"])
        out.update({f"runner/state/{k}": v.detach().float().cpu().numpy()
                    for k, v in res.state.model.state_dict().items()})
    return out


def tp_steps(case: dict, sd: dict, batches: list[dict], evals: list[dict], device, mesh=None,
             ckpt_dir: str | None = None) -> dict:
    """``len(batches)`` steps of a Transformer of ``case["cfg"]`` from the
    whole state dict ``sd`` (this rank's shards over ``mesh``: its
    ``transformer_specs``), ``case["optimizer"]`` placed on the mesh and
    the step's ``StepOptions(**case["options"])``, each batch the global
    one and this rank stepping on its data shard's rows; the causal LM
    loss chunked at ``case["chunk"]`` or the MLM loss (``case["mlm"]``).
    After each step, the largest difference of a replicated parameter
    across the ranks (0: bitwise equal). Then the state gathered whole
    (``whole/``), the ``ShardedEvaluator``'s totals over ``evals``, and with
    ``ckpt_dir`` a save there and a restore of it into a fresh state at the
    same mesh, held bitwise against the saved one (``restored_equal``).
    Without a mesh: one process on the global batches. Also each flash
    and LN+matmul wrapper's launches during the steps (``launches/``) and
    each step's wall ms (and on the card the peak memory of the steps,
    ``peak_gib``). ``case["whole"]``: ``"params"`` keeps only the
    gathered parameters, on rank 0 alone, and every rank a SHA-256 of each
    gathered leaf's bytes (``digest/``; none in one process), for states
    too large to save whole on every rank. ``case["pipeline"]`` (on a
    mesh): the pipelined family instead (this rank's stage made by
    ``init_pipelined`` from the case's seed, or by ``build_pipelined``
    from ``sd``, with its ``virtual`` chunks and ``microbatches``; the
    LM loss never chunked, as JAX's pipelined path); ``case["restore"]``:
    a step dir restored into the state before the steps."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm
    from distributed_tensorflow_tpu_torch.obs.registry import Registry
    from distributed_tensorflow_tpu_torch.parallel import collectives as col
    from distributed_tensorflow_tpu_torch.train import checkpoint as tck
    from distributed_tensorflow_tpu_torch.train.evaluation import ShardedEvaluator

    device = torch.device(device)
    cfg = ttfm.TransformerConfig(**case["cfg"])
    pipe = case.get("pipeline") if mesh is not None else None
    if sd is None and not pipe:  # random weights from the case's seed, made on the device
        sd = ttfm.init_params(cfg, seed=case["seed"], device=device, trainable=True)

    def fresh():
        if pipe:  # this stage's of the case's seed, or of ``sd``
            kw = dict(trainable=True, mesh=mesh, n_virtual=pipe["virtual"],
                      n_microbatches=pipe["microbatches"])
            model = (ttfm.init_pipelined(cfg, case["seed"], device, **kw) if sd is None else
                     ttfm.build_pipelined(cfg, {k: torch.as_tensor(v) for k, v in sd.items()},
                                          device, **kw))
        else:
            params = {k: torch.as_tensor(v) for k, v in sd.items()}
            model = ttfm.build(cfg, params, device, trainable=True, mesh=mesh,
                               specs={} if mesh is None else ttfm.transformer_specs(cfg, mesh))
        opt = topt.make_optimizer(topt.OptimizerConfig(**case["optimizer"]),
                                  model.parameters())
        if mesh is not None:
            opt.place(mesh, model.specs, model)
        return tstep.init_train_state(model, opt)

    state = fresh()
    model = state.model
    specs = model.specs
    if case.get("restore"):
        ck = tck.Checkpointer(tck.CheckpointConfig(directory=case["restore"], async_save=False))
        try:
            ck.restore(state)
        finally:
            ck.close()
    loss_fn = (ttfm.mlm_loss_fn(model) if case.get("mlm") else ttfm.lm_loss_fn(model) if pipe
               else ttfm.causal_lm_loss(model, case.get("chunk", 0)))
    step = tstep.make_train_step(loss_fn, tstep.StepOptions(**case.get("options", {})),
                                 mesh=mesh)
    replicated = [n for n, _ in model.named_parameters()
                  if not any(specs.get(n, ())) and not isinstance(specs.get(n), StageSpec)]
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as lnm
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dkv": fa.flash_bwd_dkv,
                "flash_bwd_dq": fa.flash_bwd_dq, "ln_matmul": lnm.ln_matmul,
                "ln_matmul_bwd_dx": lnm.ln_matmul_bwd_dx, "ln_matmul_bwd_dw": lnm.ln_matmul_bwd_dw}
    before = {n: w.launches for n, w in counters.items()}
    losses, norms, drift, step_ms = [], [], [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for b in batches:
        rows = shard_host_batch(b, mesh) if mesh is not None else b
        rows = {k: torch.as_tensor(v).to(device) for k, v in rows.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step(state, rows)
        losses.append(float(m["loss"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        norms.append(float(m.get("grad_norm", np.nan)))
        if mesh is not None:
            flat = torch.cat([model.get_parameter(n).detach().reshape(-1) for n in replicated])
            lo = col.all_reduce_min(flat, ("pipe", "data", "fsdp", "seq", "model"), mesh)
            hi = col.all_reduce_max(flat, ("pipe", "data", "fsdp", "seq", "model"), mesh)
            drift.append(float((hi - lo).abs().max()))
    out = {"losses": np.asarray(losses), "grad_norms": np.asarray(norms),
           "drift": np.asarray(drift), "step_ms": np.asarray(step_ms)}
    if device.type == "cuda":
        out["peak_gib"] = np.asarray(torch.cuda.max_memory_allocated(device) / 2 ** 30)
    out.update({f"launches/{n}": np.asarray(w.launches - before[n])
                for n, w in counters.items()})
    whole = tstep.whole_leaves(state)
    if case.get("whole") == "params":
        import hashlib

        if mesh is not None:  # the ranks' states compared by digest
            out.update({f"digest/{k}": np.asarray(hashlib.sha256(
                v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()) for k, v in whole})
        if mesh is None or cluster.process_index() == 0:
            out.update({f"whole/{k}": v.detach().float().cpu().numpy() for k, v in whole
                        if k.startswith("model/")})
    else:
        out.update({f"whole/{k}": v.detach().float().cpu().numpy() for k, v in whole})
    del whole
    eval_fn = (ttfm.mlm_eval_fn(model) if case.get("mlm")
               else ttfm.lm_eval_fn(model, 0 if pipe else case.get("chunk", 0)))
    totals = ShardedEvaluator(eval_fn, mesh, registry=Registry()).run(
        state, [shard_host_batch(b, mesh) if mesh is not None else b for b in evals])
    out.update({f"eval/{k}": np.asarray(v) for k, v in totals.items()})
    if ckpt_dir is not None:
        ck = tck.Checkpointer(tck.CheckpointConfig(directory=ckpt_dir, async_save=False))
        try:
            ck.save(state.step, state, force=True, trigger="final")
        finally:
            ck.close()
        other = fresh()
        ck = tck.Checkpointer(tck.CheckpointConfig(directory=ckpt_dir, async_save=False))
        try:
            ck.restore(other)
        finally:
            ck.close()
        out["restored_equal"] = np.asarray(all(
            torch.equal(a, b) for (_, a), (_, b) in zip(tstep.state_leaves(state),
                                                        tstep.state_leaves(other))))
    out["model"] = model
    return out


def job_tp(spec: dict, dev, mesh) -> dict:
    """Each of ``cases`` (``tp_steps``) on its ``mesh`` from the ``sd/``,
    ``<tag>/train<i>/<key>`` and ``<tag>/eval<i>/<key>`` arrays of
    ``inputs``, saved under its tag (and the case's wall seconds,
    ``wall_s``); with ``runner`` (workload ->
    overrides) also ``run_workload``'s losses, mesh and gathered weights
    (``runner/<workload>/``)."""
    data = np.load(spec["inputs"])
    out = {}
    for case in spec["cases"]:
        tag = case["tag"]
        src = case.get("sd", "sd")
        sd = ({k[len(src) + 1:]: data[k] for k in data.files if k.startswith(src + "/")}
              if "seed" not in case else None)

        def batches(prefix):
            keys = [k for k in data.files if k.startswith(f"{tag}/{prefix}")]
            n = len({k.split("/")[1] for k in keys})
            return [{k.split("/")[2]: data[k] for k in keys
                     if k.startswith(f"{tag}/{prefix}{i}/")} for i in range(n)]

        cmesh = build_mesh(MeshSpec(**case["mesh"]), dev)
        if case.get("env"):
            os.environ.update(case["env"])
        if case.get("restore"):
            case = dict(case, restore=os.path.join(spec["out"], case["restore"]))
        t0 = time.perf_counter()
        res = tp_steps(case, sd, batches("train"), batches("eval"), dev, cmesh,
                       os.path.join(spec["out"], f"ck_{tag}") if case.get("save", True)
                       else None)
        res.pop("model")
        res["wall_s"] = np.asarray(time.perf_counter() - t0)
        out.update({f"{tag}/{k}": v for k, v in res.items()})
    for workload, over in spec.get("runner", {}).items():
        from distributed_tensorflow_tpu_torch.train import step as tstep_
        from distributed_tensorflow_tpu_torch.workloads import run_workload

        res = run_workload(workload, over, device=str(dev))
        out[f"runner/{workload}/losses"] = np.asarray([h["loss"] for h in res.history])
        out[f"runner/{workload}/mesh"] = np.asarray([res.mesh.shape[a] for a in
                                                     ("data", "fsdp", "model")])
        out[f"runner/{workload}/seq"] = np.asarray(res.mesh.shape["seq"])
        out[f"runner/{workload}/pipe"] = np.asarray(res.mesh.shape["pipe"])
        out.update({f"runner/{workload}/whole/{k}": v.detach().float().cpu().numpy()
                    for k, v in tstep_.whole_leaves(res.state) if k.startswith("model/")})
    return out


def job_seq(spec: dict, dev, mesh) -> dict:
    """Each of ``attention`` through every schedule of
    ``sequence_parallel_attention`` (module docstring; their wall seconds
    ``attention/wall_s``), then ``job_tp``'s ``cases`` and ``runner``."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as col
    from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
        IMPLS, sequence_parallel_attention)
    from distributed_tensorflow_tpu_torch.parallel.sharding import local_rows

    torch.set_num_threads(1)  # four ranks of tiny tensors: threads only contend
    data = np.load(spec["inputs"])
    out = {}

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq)

    def attend(tag, amesh, impl, causal, masked, dtype=torch.float32):
        q, k, v, cot = (torch.as_tensor(data[f"{tag}/{n}"]) for n in ("q", "k", "v", "cot"))
        rows = local_rows(q.shape[0], amesh)
        n, m = amesh.shape["model"], col.axis_index("model", amesh)
        heads = slice(m * q.shape[1] // n, (m + 1) * q.shape[1] // n)
        leaves = [t[rows, heads].to(dev, dtype).requires_grad_() for t in (q, k, v)]
        mask = torch.as_tensor(data[f"{tag}/mask"])[rows].to(dev) if masked else None
        before = [w.launches for w in kernels]
        o = sequence_parallel_attention(*leaves, amesh, impl=impl, causal=causal,
                                        kv_mask=mask)
        (o * cot[rows, heads].to(dev, dtype)).sum().backward()
        launches = torch.tensor([w.launches - b for w, b in zip(kernels, before)])
        return {"out": o, **{f"d{n_}": t.grad for n_, t in zip("qkv", leaves)},
                "launches": launches}

    t0 = time.perf_counter()
    for a in spec["attention"]:
        tag, amesh = a["tag"], build_mesh(MeshSpec(**a["mesh"]), dev)
        dtype = getattr(torch, a.get("dtype", "float32"))
        runs = a.get("runs") or [(impl, causal, masked) for impl in IMPLS
                                 for causal in (False, True) for masked in (False, True)]
        for impl, causal, masked in runs:
            res = attend(tag, amesh, impl, bool(causal), bool(masked), dtype)
            out.update({f"{tag}/{impl}/{int(causal)}{int(masked)}/{k}":
                        v.detach().float().cpu().numpy() for k, v in res.items()})
        if a.get("emulated"):
            native, col._native_p2p = col._native_p2p, lambda group, x: False
            try:
                for causal, masked in ((True, True), (False, False)):
                    res = attend(tag, amesh, "ring", causal, masked)
                    out.update({f"{tag}/emulated/{int(causal)}{int(masked)}/{k}":
                                v.detach().float().cpu().numpy() for k, v in res.items()})
            finally:
                col._native_p2p = native
    out["attention/wall_s"] = np.asarray(time.perf_counter() - t0)
    out.update(job_tp(dict(spec, cases=spec.get("cases", [])), dev, mesh))
    return out


def job_pipe(spec: dict, dev, mesh) -> dict:
    """``apply`` and ``forward`` (module docstring), then ``job_tp``'s
    ``cases`` and ``runner``."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm
    from distributed_tensorflow_tpu_torch.parallel import collectives as col
    from distributed_tensorflow_tpu_torch.parallel.pipeline import pipeline_apply
    from distributed_tensorflow_tpu_torch.parallel.sharding import gather_tensor, local_rows

    torch.set_num_threads(1)  # four ranks of tiny tensors: threads only contend
    data = np.load(spec["inputs"])
    out = {}
    batch = ("data", "fsdp")
    for a in spec.get("apply", []):
        tag, amesh = a["tag"], build_mesh(MeshSpec(**a["mesh"]), dev)
        w, b = (torch.as_tensor(data[f"{tag}/{n}"]).to(dev).requires_grad_() for n in "wb")
        x = torch.as_tensor(data[f"{tag}/x"]).to(dev)
        y = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), {"w": w, "b": b},
                           x[:, local_rows(x.shape[1], amesh)], amesh, n_virtual=a["virtual"])
        grads = torch.autograd.grad((y ** 2).sum(), [w, b])
        out[f"{tag}/out"] = y.detach().cpu().numpy()
        for n, g in zip(("dw", "db"), grads):
            out[f"{tag}/{n}"] = col.all_reduce(g, ("pipe", *batch), amesh).cpu().numpy()
    for f in spec.get("forward", []):
        tag, fmesh = f["tag"], build_mesh(MeshSpec(**f["mesh"]), dev)
        cfg = ttfm.TransformerConfig(**f["cfg"])
        sd = {k[len(f"sd_{tag}/"):]: torch.as_tensor(data[k]) for k in data.files
              if k.startswith(f"sd_{tag}/")}
        model = ttfm.build_pipelined(cfg, sd, dev, trainable=True, mesh=fmesh,
                                     n_virtual=f["virtual"], n_microbatches=f["microbatches"])
        ids = torch.as_tensor(data[f"{tag}/ids"])
        rows = local_rows(ids.shape[0], fmesh)
        opt = {k: torch.as_tensor(data[f"{tag}/{k}"])[rows].to(dev)
               for k in ("mask", "positions") if f"{tag}/{k}" in data.files}
        logits = model(ids[rows].to(dev), opt.get("mask"), positions=opt.get("positions"))
        numel = logits.numel() * col.axis_size(batch, fmesh)  # the global logits'
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad((logits ** 2).sum() / numel, list(model.parameters()))
        out[f"{tag}/logits"] = logits.detach().cpu().numpy()
        for n, g in zip(names, grads):
            g = col.all_reduce(g, batch, fmesh)
            spec_ = model.specs.get(n, ())
            if spec_:
                g = gather_tensor(g, spec_, fmesh, model.global_shapes[n])
            out[f"{tag}/grad/{n}"] = g.cpu().numpy()
    out.update(job_tp(dict(spec, cases=spec.get("cases", [])), dev, mesh))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(spec: dict, world: int = 2):
    """Write ``spec`` into its ``out`` directory and start ``world`` ranks
    of this script on it, each with torchrun's variables (a free port on
    localhost); their output goes to ``rank<r>.log`` there."""
    import subprocess

    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port, procs = free_port(), []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), LOCAL_RANK=str(r), PYTHONPATH=REPO)
        log = open(os.path.join(spec["out"], f"rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), path],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait(procs, out: str, timeout: float) -> list[dict]:
    """Each rank's saved arrays once every rank has exited 0; raises with
    the ranks' logs otherwise (a rank still running at ``timeout`` is
    killed)."""
    import subprocess
    import time

    deadline, codes = time.monotonic() + timeout, []
    for p, log in procs:
        try:
            codes.append(p.wait(max(deadline - time.monotonic(), 0.1)))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
        log.close()
    if any(codes):
        logs = "".join(open(os.path.join(out, f"rank{r}.log")).read()[-4000:]
                       for r in range(len(procs)))
        raise RuntimeError(f"ranks exited {codes}:\n{logs}")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(len(procs))]


def stop(procs) -> None:
    """Kill the ranks (the caller failed before waiting for them)."""
    for p, log in procs:
        p.kill()
        p.wait()
        log.close()


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    if spec.get("backend") == "gloo" and device == "cuda":
        # every rank on card 0, which NCCL refuses: the group is started
        # here over gloo (it reduces and broadcasts CUDA tensors), and
        # ``initialize`` keeps a group that is up
        import torch.distributed as dist

        torch.cuda.set_device(0)
        dist.init_process_group("gloo")
        device = "cuda:0"
    dev = cluster.initialize(cluster.ClusterConfig(), device)
    try:
        if spec["device"] == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        mesh = build_mesh(MeshSpec(data=-1), dev)
        jobs = {"job_resnet": job_resnet, "job_bert": job_bert, "job_parallel": job_parallel,
                "job_ckpt": job_ckpt, "job_ckpt_fallback": job_ckpt_fallback,
                "job_wide_deep": job_wide_deep, "job_cnn": job_cnn, "job_gpt": job_gpt,
                "job_tp": job_tp, "job_seq": job_seq, "job_pipe": job_pipe}
        out = jobs[f"job_{spec['job']}"](spec, dev, mesh)
        np.savez(os.path.join(spec["out"], f"rank{cluster.process_index()}.npz"), **out)
    finally:
        cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
