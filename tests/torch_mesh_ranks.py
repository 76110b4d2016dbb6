"""Rank processes for the port's mesh tests: spawned over gloo on the CPU.

:func:`run_ranks` starts one process per rank, each a fresh interpreter that
imports this module (no JAX: nothing here imports it) and runs one of its
``rank_*`` functions on a mesh, and returns what each rank returned;
:func:`start_cli` starts one that runs the CLI on slim presets. The
parent's own work (the one-process reference, the JAX side) runs while the
ranks do. Every rendezvous, collective and join has a timeout: a hung rank
fails the run, it does not stall it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COLLECTIVE_TIMEOUT_S = 90.0
# limits of ``relative_errors`` for the meshed fp32 steps against one process (the
# largest seen on this configuration: 2.5e-4 of the whole, 3e-3 of one tensor)
WHOLE_RTOL, TENSOR_RTOL = 1e-3, 1e-2
CLIP = 1e-3  # the global-norm clip of ``clipped``: below every test module's gradient norm

_CHILD = ("import sys; sys.path[:0] = [{here!r}, {repo!r}]; import torch_mesh_ranks as r; "
          "r._child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])")
_CLI_CHILD = ("import sys; sys.path[:0] = [{here!r}, {repo!r}]; import torch_mesh_ranks as r; "
              "r._cli_child(int(sys.argv[1]), sys.argv[2])")


class Ranks:
    """Processes started by :func:`start_ranks`; :meth:`results` joins them."""

    def __init__(self, procs, outs, tmp, timeout):
        self.procs, self.outs, self.tmp, self.timeout = procs, outs, tmp, timeout
        self.t0 = time.monotonic()

    def results(self):
        try:
            for p in self.procs:
                left = self.timeout - (time.monotonic() - self.t0)
                try:
                    p.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    raise TimeoutError(f"a rank did not finish within {self.timeout} s")
            logs = [p.stdout.read() for p in self.procs]
            for rank, (p, log) in enumerate(zip(self.procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {rank} exited with {p.returncode}:\n{log[-4000:]}")
            return [torch.load(o, weights_only=False) for o in self.outs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
                p.stdout.close()
            self.tmp.cleanup()


def start_ranks(target: str, world: int, args: dict, timeout: float = 240.0, device: str = "cpu",
                backend: str = "gloo") -> Ranks:
    """Start ``world`` ranks running ``target(rank, world, args)`` of this module
    on ``device`` (all of them; ``cuda:0`` shares one card) over ``backend``."""
    from cenet_tpu_torch.core.mesh import free_port

    tmp = tempfile.TemporaryDirectory()
    inp = os.path.join(tmp.name, "args.pt")
    torch.save(args, inp)
    port = str(free_port())
    code = _CHILD.format(here=HERE, repo=REPO)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, outs = [], []
    for rank in range(world):
        outs.append(os.path.join(tmp.name, f"out{rank}.pt"))
        procs.append(subprocess.Popen([sys.executable, "-c", code, target, str(rank), str(world), port, inp, outs[-1],
                                       device, backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                      env=env))
    return Ranks(procs, outs, tmp, timeout)


def run_ranks(target: str, world: int, args: dict, timeout: float = 240.0, **kw):
    return start_ranks(target, world, args, timeout, **kw).results()


def _child(target, rank, world, port, inp, out, device, backend):
    from cenet_tpu_torch.core import mesh as M

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons
    M.init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend, device=device,
                       timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        result = globals()[target](rank, world, torch.load(inp, weights_only=False))
        torch.save(result, out)
    finally:
        M.shutdown_distributed()


def slim_preset(get_preset, img_size):
    """``get_preset`` with every preset's image size cut to ``img_size``."""
    def get(name):
        cfg = get_preset(name)
        return cfg.replace(data=dataclasses.replace(cfg.data, img_size=img_size))

    return get


def cli_command(argvs, img_size):
    """The command of a process that runs ``cli.main(argv)`` for each of
    ``argvs`` in turn (a host of a ``--coordinator`` run, say, or a rank that
    ``RANK`` in its environment names), on the presets cut to ``img_size``, its
    rendezvous and collectives failing after ``COLLECTIVE_TIMEOUT_S``."""
    code = _CLI_CHILD.format(here=HERE, repo=REPO)
    return [sys.executable, "-c", code, str(img_size), json.dumps([list(a) for a in argvs])]


def start_cli(argvs, img_size):
    """:func:`cli_command`'s process, its output in its ``stdout`` pipe."""
    return subprocess.Popen(cli_command(argvs, img_size), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})


def _cli_child(img_size, argvs):
    from cenet_tpu_torch.core import config
    from cenet_tpu_torch.core import mesh as M

    torch.set_num_threads(1)
    config.get_preset = slim_preset(config.get_preset, img_size)
    M.DEFAULT_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    from cenet_tpu_torch.cli import main as cli

    for argv in json.loads(argvs):
        cli.main(argv)


# -- configurations -----------------------------------------------------------


def dp_config(loss_type="boundary", loss_weights="1.0", batch=8, drop_path_rate=0.1, grad_clip=0.1,
              heads=(2, 2, 2), amp=False, attn_impl="pallas"):
    """CENet-b0 at 64 px on the ACDC preset (``tests/test_trainer.py:118-158``'s
    configuration), with drop-path and the clip on."""
    from cenet_tpu_torch.core.config import get_preset

    cfg = get_preset("acdc")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, input_channels=1, num_classes=4, scale_factors=(1.0, 0.5),
                                  diffatt_num_heads=heads, encoder="pvt_v2_b0", drop_path_rate=drop_path_rate,
                                  attn_impl=attn_impl),
        train=dataclasses.replace(cfg.train, max_epochs=1, batch_size=batch, base_lr=0.01, optimizer="sgd",
                                  scheduler="poly", loss_type=loss_type, loss_weights=loss_weights, amp=amp,
                                  grad_clip=grad_clip),
    )


def batch(b, seed=0, size=64, classes=4):
    """A seeded (images (B, 1, S, S), labels (B, S, S)) batch whose class mix
    moves along the batch (sample i mostly class ⌊classes·i/B⌋), so that the
    ranks' rows have other class sums than the global batch: a sum left local
    changes the loss."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.standard_normal((b, 1, size, size)).astype(np.float32))
    labels = rng.integers(0, classes, (b, size, size))
    dominant = (classes * np.arange(b) // b)[:, None, None]
    labels = np.where(rng.random((b, size, size)) < 0.7, dominant, labels)
    return images, torch.from_numpy(labels.astype(np.int64))


def train(cfg, mesh=None, steps=2, seed=0, device="cpu"):
    """``steps`` train steps of a fresh trainer on ``device`` (the mesh's under
    ``mesh``) on the seeded global batch (the
    rank's rows under a mesh): {"losses", "state" (gathered, full), "plan" (the
    sharded keys), "impl" (the trainer's attn_impl)}."""
    from cenet_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, max_iterations=10, device=None if mesh else device, mesh=mesh)
    init = None if mesh else {k: v.detach().cpu().clone() for k, v in tr.state_dict()["state_dict"].items()}
    images, labels = batch(cfg.train.batch_size, seed)
    if mesh is not None:
        rows = mesh.rows(images.shape[0])
        images, labels = images[rows], labels[rows]
    images, labels = images.to(tr.device), labels.to(tr.device)
    losses = [float(tr.train_step(images, labels)) for _ in range(steps)]
    return {"losses": losses, "state": _cpu(tr.state_dict()), "plan": sorted(tr.tp_plan),
            "impl": tr.cfg.model.attn_impl, "init": init}


def relative_errors(state, ref, init):
    """How far ``state``'s parameter updates and SGD momentum slots (the gradients'
    running sums) lie from ``ref``'s (full train states, both stepped from the
    weights ``init``): {"update": …, "slot": …}, each (the error over all
    tensors relative to the reference's whole norm, the largest error of one
    tensor relative to its own norm). The updates and slots are small beside
    the weights, so these see a fault on the gradient path that a max-abs on
    the weights cannot. A tensor whose reference norm is under 1e-6 of the
    largest (a BatchNorm bias ahead of another BatchNorm, whose gradient is
    rounding noise) counts in the whole norm only."""
    upd = {k: (state["state_dict"][k], ref["state_dict"][k], init[k]) for k in ref["optimizer"]["state"]}
    slots = {n: (s["trace"], ref["optimizer"]["state"][n]["trace"], torch.zeros(()))
             for n, s in state["optimizer"]["state"].items()}
    return {"update": _relative(upd), "slot": _relative(slots)}


def _relative(triples):
    err, base = {}, {}
    for k, (a, b, origin) in triples.items():
        err[k] = (a.double() - b.double()).norm().item()
        base[k] = (b.double() - origin.double()).norm().item()
    whole = (sum(e * e for e in err.values()) / sum(x * x for x in base.values())) ** 0.5
    floor = 1e-6 * max(base.values())
    return whole, max(err[k] / base[k] for k in base if base[k] > floor)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


# -- rank functions -----------------------------------------------------------


def rank_train(rank, world, args):
    """Each case of ``args["cases"]`` (config kwargs, mesh (data, model[, seq])) trained
    on its mesh: {"train": [``train``'s record] per case}; with
    ``args["unequal_ce"]`` also the error that the CE loss raises when this
    rank's batch is one row longer than the others' ({"unequal_ce": message})."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.train.losses import Criterion

    out = {"train": []}
    device = args.get("device", "cpu")
    for kw, shape in args["cases"]:
        data, model, seq = (*shape, 1)[:3]
        mesh = M.make_mesh(M.MeshConfig(data=data, model=model, seq=seq), device=device)
        out["train"].append(train(dp_config(**kw), mesh))
    if args.get("unequal_ce"):
        M.set_attention_mesh(M.make_mesh(M.MeshConfig(data=world), device="cpu"))
        images, labels = batch(2 + rank)
        try:
            Criterion(4, "ce", "1.0")(torch.randn(2 + rank, 4, 64, 64), labels)
            out["unequal_ce"] = None
        except ValueError as e:
            out["unequal_ce"] = str(e)
        M.set_attention_mesh(None)
    return out


def build_module(kind, kw):
    """A head-sharded attention module of the port by class name."""
    from cenet_tpu_torch.nn import attention

    return getattr(attention, kind)(**kw)


def run_module(mod, spec):
    """(output, input gradients, parameter gradients) of ``mod`` on ``spec``'s
    inputs, backward from ``spec["g"]``."""
    xs = [x.clone().requires_grad_() for x in spec["inputs"]]
    out = mod(*xs, *spec.get("extra", ()))
    out.backward(spec["g"])
    return out.detach(), [x.grad for x in xs], {n: p.grad for n, p in mod.named_parameters()}


def clipped(mod, grads, plan, mesh):
    """``mod``'s gradients ``grads`` as the trainer's optimizer clips them to a
    global norm of ``CLIP`` (its SGD slot after one step at weight decay 0 and
    lr 0), gathered: the norm adds the squares of the pieces in ``plan`` over
    the model group and counts the replicated gradients once."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.train.optim import Optimizer

    opt = Optimizer("sgd", lambda step: 0.0, weight_decay=0.0, grad_clip=CLIP)
    opt.sharded, opt.model_group = frozenset(plan), mesh.model_group
    opt.step(dict(mod.named_parameters()), grads)
    return M.gather_state_dict({n: s["trace"] for n, s in opt.state_dict()["state"].items()}, mesh, plan)


def rank_tp(rank, world, args):
    """On a (1, ``world``) mesh: each module of ``args["modules"]`` (loaded with
    its full weights, then head-sharded where its heads divide): (sharded, out,
    input grads, the full parameter gradients gathered, the gradients as the
    optimizer clips them gathered); each of
    ``args["unsharded"]`` run without the mesh, with it (its cores through
    ``router.shard_heads``) and sharded ((out, input grads) each); the state round trip
    of ``args["full_state"]`` (shard, gather) with this rank's kv piece; then
    ``rank_train``'s cases."""
    from cenet_tpu_torch.core import mesh as M

    mesh = M.make_mesh(M.MeshConfig(data=1, model=world), device="cpu")
    M.set_attention_mesh(mesh)
    modules = []
    for spec in args["modules"]:
        mod = build_module(spec["kind"], spec["kw"])
        mod.load_state_dict(spec["state"], strict=True)
        sharded = mod.shard_heads_(mesh)
        out, gx, gp = run_module(mod, spec)
        plan = {k: r for k, r in mod.TP_PLAN.items() if k in gp} if sharded else {}
        modules.append((sharded, out, gx, M.gather_state_dict(gp, mesh, plan), clipped(mod, gp, plan, mesh)))
    unsharded = []
    for spec in args["unsharded"]:
        mod = build_module(spec["kind"], spec["kw"])
        mod.load_state_dict(spec["state"], strict=True)
        M.set_attention_mesh(None)
        alone = run_module(mod, spec)  # the one-process module
        M.set_attention_mesh(mesh)
        mod.zero_grad()
        heads = run_module(mod, spec)  # whole weights, each core on the rank's heads (router.shard_heads)
        mod.zero_grad()
        sharded = mod.shard_heads_(mesh)
        after = run_module(mod, spec)  # the rank's weights
        unsharded.append((sharded, alone[:2], heads[:2], after[:2]))
    full = args["full_state"]
    local = M.shard_state_dict(full, mesh)
    back = M.gather_state_dict(local, mesh)
    M.set_attention_mesh(None)
    result = rank_train(rank, world, {"cases": args["cases"]})
    result.update(modules=modules, unsharded=unsharded, round_trip=all(torch.equal(back[k], full[k]) for k in full),
                  local_kv=local["attn.kv.weight"], local_keys={k: tuple(v.shape) for k, v in local.items()})
    return result


# -- the seq axis: ring attention -----------------------------------------------


def ring_core_run(impl, q, k, v, co):
    """The ``impl`` core (``nn.attention.get_attention_core``) on q, k, v and the
    gradients of Σ out∘co: (out, (dq, dk, dv))."""
    from cenet_tpu_torch.nn.attention import get_attention_core

    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = get_attention_core(impl)(*xs)
    (out * co).sum().backward()
    return out.detach(), [x.grad for x in xs]


def ring_diff_run(impl, q, k, v, lam, co):
    """``router.diff_attention_interleaved`` under ``impl`` and the gradients of
    Σ out∘co: (out, (dq, dk, dv, dλ))."""
    from cenet_tpu_torch.ops import router

    xs = [t.clone().requires_grad_() for t in (q, k, v, lam)]
    out = router.diff_attention_interleaved(*xs, impl=impl)
    (out * co).sum().backward()
    return out.detach(), [x.grad for x in xs]


def ring_module_run(spec, mesh):
    """A module of ``spec`` (train mode, its full weights) on ``mesh``: head-sharded
    where ``mesh.model`` divides its heads, on the rank's rows of the inputs.
    (output rows, input-gradient rows, the full parameter gradients: summed over
    the data group, the sharded ones gathered over the model group)."""
    import torch.distributed as dist

    from cenet_tpu_torch.core import mesh as M

    mod = build_module(spec["kind"], spec["kw"]).train()
    mod.load_state_dict(spec["state"], strict=True)
    sharded = mod.shard_heads_(mesh) if hasattr(mod, "shard_heads_") else False
    rows = mesh.rows(spec["inputs"][0].shape[0])
    local = dict(spec, inputs=[x[rows] for x in spec["inputs"]], g=spec["g"][rows])
    out, gx, gp = run_module(mod, local)
    if mesh.data_group is not None and mesh.data > 1:
        for g in gp.values():
            dist.all_reduce(g, group=mesh.data_group)
    plan = {k: r for k, r in mod.TP_PLAN.items() if k in gp} if sharded else {}
    return out, gx, M.gather_state_dict(gp, mesh, plan), sharded


def rank_ring(rank, world, args):
    """Two ranks on the (1, 1, 2) mesh: the ring core's cases (``args["core"]``:
    impl, q, k, v, co), its fallbacks (``args["fallback"]``: q, k, v, each run
    through ``'ring'``, which must not ride the ring), the diff-attention
    route (``args["diff"]``: impl, q, k, v, λ, co), the modules
    (``args["modules"]``), two fp32 steps of ``args["train"]``'s configuration,
    and last each ``cli.main`` argv of ``args["cli"]`` in turn (``cli train``,
    then ``cli eval``, each ``--mesh 1,1,2``) as rank ``rank`` of a fresh run
    at the ports ``args["cli_ports"]``, on the presets cut to ``args["cli_img"]``."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.nn.attention import get_attention_core

    mesh = M.make_mesh(M.MeshConfig(data=1, model=1, seq=2), device="cpu")
    M.set_attention_mesh(mesh)
    out = {"place": (mesh.d, mesh.s, mesh.m, mesh.seq_ranks)}
    out["core"] = [ring_core_run(*case) for case in args["core"]]
    with torch.no_grad():
        out["fallback"] = [get_attention_core("ring")(*case) for case in args["fallback"]]
    out["diff"] = [ring_diff_run(*case) for case in args["diff"]]
    out["modules"] = [ring_module_run(spec, mesh) for spec in args["modules"]]
    out["cost"] = ring_model_cost()
    M.set_attention_mesh(None)
    out["train"] = train(dp_config(**args["train"]), M.make_mesh(M.MeshConfig(data=1, model=1, seq=2), device="cpu"))
    M.shutdown_distributed()
    out["cli"] = [ring_cli(rank, world, argv, port, args["cli_img"])
                  for argv, port in zip(args["cli"], args["cli_ports"])]
    return out


def ring_model_cost():
    """``model_cost`` of CENet-b0 at 64 px with ``attn_impl='ring'`` under the
    registered mesh, and the collectives it called (none: ``meta`` tensors take
    the ring core's plain fallback)."""
    import torch.distributed as dist

    from cenet_tpu_torch.core.stats import model_cost
    from cenet_tpu_torch.models.cenet import build_model

    names = ("all_reduce", "all_gather", "broadcast", "batch_isend_irecv")
    saved, called = {n: getattr(dist, n) for n in names}, []
    for n in names:
        setattr(dist, n, lambda *a, _n=n, **k: called.append(_n) or saved[_n](*a, **k))
    try:
        cost = model_cost(build_model(dp_config(attn_impl="ring"), device="cpu", seed=0), (1, 1, 64, 64))
    finally:
        for n in names:
            setattr(dist, n, saved[n])
    return cost, called


def ring_cli(rank, world, argv, port, img):
    """``cli.main(argv)`` as rank ``rank`` of ``world`` (``RANK`` and the
    rendezvous at ``port`` in the environment, as a launched-alone CLI hands
    them to the ranks it starts), on the presets cut to ``img``: the trained
    state (train) or the metrics (eval), and what the rank printed."""
    import contextlib
    import io

    from cenet_tpu_torch.cli import main as cli
    from cenet_tpu_torch.core import config
    from cenet_tpu_torch.core import mesh as M

    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    config.get_preset = slim_preset(config.get_preset, img)
    M.DEFAULT_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    if argv[0] == "train":
        return {"state": _cpu(result.state_dict()), "impl": result.cfg.model.attn_impl, "printed": buf.getvalue()}
    return {"result": result, "printed": buf.getvalue()}


def rank_ring_modules(rank, world, args):
    """Four ranks: the modules of ``args["modules"]`` on each mesh (data, model,
    seq) of ``args["meshes"]``, as ``ring_module_run`` runs them; then each
    ``cli.main`` argv of ``args["cli"]`` in turn, as ``ring_cli`` runs it, at
    the ports ``args["cli_ports"]``."""
    from cenet_tpu_torch.core import mesh as M

    out = {}
    for data, model, seq in args["meshes"]:
        mesh = M.make_mesh(M.MeshConfig(data=data, model=model, seq=seq), device="cpu")
        M.set_attention_mesh(mesh)
        out[(data, model, seq)] = [ring_module_run(spec, mesh) for spec in args["modules"]]
        M.set_attention_mesh(None)
    M.shutdown_distributed()
    out["cli"] = [ring_cli(rank, world, argv, port, args["cli_img"])
                  for argv, port in zip(args["cli"], args["cli_ports"])]
    return out


def rank_ring_forward(rank, world, args):
    """The eval-mode logits of ``args["cfg"]``'s model with ``args["state"]`` on
    ``args["x"]``, on the (1, 1, ``world``) mesh."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.models.cenet import build_model

    M.set_attention_mesh(M.make_mesh(M.MeshConfig(data=1, model=1, seq=world), device="cpu"))
    model = build_model(args["cfg"], device="cpu", seed=0)
    model.load_state_dict(args["state"], strict=True)
    with torch.no_grad():
        return model.eval()(args["x"])
