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
  divergence check, ``broadcast_from_chief``, ``replicate`` and the
  mesh's refusals, each result saved for the test to hold against numpy.

``train_steps`` and ``bert_steps`` are also what the one-process
references run (no mesh);
``launch`` starts the ranks of a spec, ``wait`` collects them and
``stop`` kills them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from distributed_tensorflow_tpu_torch.models import common, resnet  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import cluster  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.sharding import shard_host_batch  # noqa: E402
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


def bert_steps(cfg, sd: dict, batches: list[dict], optimizer: dict, device, mesh=None) -> dict:
    """``len(batches)`` steps of a Transformer of ``cfg`` from state dict
    ``sd`` with ``optimizer`` and ``mlm_loss_fn`` on ``device``: with
    ``mesh``, each batch is the global batch and this rank steps on its
    rows. Returns the losses, the state dict after the steps (numpy) and
    the model."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm

    model = ttfm.build(cfg, {k: torch.as_tensor(v) for k, v in sd.items()}, device,
                       trainable=True)
    opt = topt.make_optimizer(topt.OptimizerConfig(**optimizer), model.parameters())
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(ttfm.mlm_loss_fn(model), mesh=mesh)
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
    refusals = []
    for call in (lambda: build_mesh(MeshSpec(data=1, model=2), dev),
                 lambda: build_mesh(MeshSpec(data=1, fsdp=2), dev),
                 lambda: col.all_reduce(x, "data", mesh, groups=[[0, 1]]),
                 lambda: col.all_to_all(x, "data", mesh, split_axis=0, concat_axis=1),
                 lambda: col.ring_permute(x, "data", mesh)):
        try:
            call()
            refusals.append("no error")
        except NotImplementedError as e:
            refusals.append(str(e))
    out["refusals"] = np.asarray(refusals)
    cluster.sync_hosts("end")
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
        jobs = {"job_resnet": job_resnet, "job_bert": job_bert, "job_parallel": job_parallel}
        out = jobs[f"job_{spec['job']}"](spec, dev, mesh)
        np.savez(os.path.join(spec["out"], f"rank{cluster.process_index()}.npz"), **out)
    finally:
        cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
