"""The ``('data', 'seq', 'model')`` mesh on ``torch.distributed``: counterpart of ``cenet_tpu/core/mesh.py``.

Each rank is one process on one device. The ranks lie on the mesh as JAX's
``make_mesh`` lays its devices out, ``reshape(data, seq, model)`` (``reshape(data,
model)`` when ``seq`` is 1): rank ``(d·seq + s)·model + m`` sits at data
position ``d``, seq position ``s`` and model position ``m``. The *data group*
of a rank is the ranks with its ``s`` and ``m`` (they hold the same weights and
see different rows of the global batch); its *model group* the ranks with its
``d`` and ``s`` (they see the same rows and hold different heads of the
head-sharded attention sites); its *seq group* the ranks with its ``d`` and
``m`` (they hold the same weights and rows, and split the tokens of the ring
attention sites between them).

GSPMD makes every reduction of the JAX step one over the global batch, and
shards the attention projections by ``TP_ATTENTION_RULES`` without changing
the math. Here the layers do that by hand, with the collectives below:

* BatchNorm's sums, the losses' batch sums and the CE mean are all-reduced
  over the data group (:func:`all_reduce_sum`, whose backward all-reduces the
  gradient), drop-path draws the global batch's mask and takes the rank's
  rows, and the CCU tests its batch on :func:`global_batch`;
* the head-sharded modules of ``nn/attention.py`` hold their rank's columns
  of q/k/v and rows of the output projection: their inputs pass
  :func:`copy_to_model` (identity forward, all-reduce backward) and their
  partial outputs :func:`reduce_from_model` (all-reduce forward, identity
  backward), Megatron's pair;
* the ring attention of ``ops/ring_attention.py`` takes the rank's block of
  the tokens of q, k and v (:func:`split_tokens`: the block forward, the
  blocks' gradients gathered over the seq group backward) and gathers the blocks of its
  output (:func:`gather_tokens`), so that everything around it stays
  replicated and equal on every seq rank; nothing sums over ``seq``;
* the trainer averages every gradient over the data group.

``all_reduce``, ``broadcast`` and ``all_gather`` run on NCCL and on gloo alike,
CUDA tensors included. The ring's hop (:func:`ring_pass`) is the one
point-to-point exchange: each rank sends its block to the next rank of its
seq group and receives the previous rank's (``dist.batch_isend_irecv``). NCCL
sends device tensors; gloo's ``send``/``recv`` read host memory, so on a gloo
group CUDA tensors are staged through host copies (chosen by the group's
backend, not by catching an error). Without an initialised process group a
:class:`Mesh` has no groups and every collective is the identity: the
one-process step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks
    model: int = 1
    seq: int = 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A rank's place on the mesh and its process groups (None without a
    process group: a one-process mesh, whose collectives are identities)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    seq: int = 1
    seq_group: Any = None

    @property
    def d(self) -> int:
        """The rank's position on the data axis: its rows of the global batch."""
        return self.rank // (self.seq * self.model)

    @property
    def s(self) -> int:
        """The rank's position on the seq axis: its block of a ring site's tokens."""
        return self.rank // self.model % self.seq

    @property
    def m(self) -> int:
        """The rank's position on the model axis: its heads of the sharded sites."""
        return self.rank % self.model

    @property
    def seq_ranks(self) -> List[int]:
        """The global ranks of the rank's seq group, in seq order."""
        return [(self.d * self.seq + s) * self.model + self.m for s in range(self.seq)]

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b`` (a multiple of ``data``);
        the ranks of a seq group hold the same rows."""
        if b % self.data:
            raise ValueError(f"a global batch of {b} does not split over data={self.data}")
        n = b // self.data
        return slice(self.d * n, (self.d + 1) * n)


def free_port() -> int:
    """A free TCP port on this host (for a local rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_DEVICE: Optional[torch.device] = None


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the default process group as rank ``process_id`` of ``num_processes``
    at ``coordinator`` (``host:port``; a free local port for a lone process) and
    return this rank's device: ``device``, or ``cuda:<LOCAL_RANK>`` when it is
    None. ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU; it
    is a parameter so that ranks sharing one card can ask for gloo. The
    rendezvous and every collective of the group fail after ``timeout_s``
    (``DEFAULT_TIMEOUT_S`` when None)."""
    global _DEVICE
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    world = num_processes or 1
    rank = process_id or 0
    if coordinator is None:
        if world > 1:
            raise ValueError("init_distributed: several processes need a coordinator address")
        coordinator = f"127.0.0.1:{free_port()}"
    dev = torch.device(device) if device is not None else torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if rank > 0:
        _wait_for_rendezvous(coordinator, timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def _wait_for_rendezvous(coordinator: str, timeout_s: float) -> None:
    """Poll rank 0's rendezvous every 50 ms until it accepts connections: a
    rank started well before rank 0 then joins at once, not after the store
    client's growing retry interval (seconds after a wait of ten)."""
    host, port = coordinator.rsplit(":", 1)
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=1.0).close()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no rendezvous at {coordinator} within {timeout_s} s")
            time.sleep(0.05)


def shutdown_distributed() -> None:
    """Leave the default process group (if any) and clear the registered mesh."""
    global _DEVICE
    set_attention_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def axis_ranks(data: int, model: int, seq: int = 1) -> Tuple[List[List[int]], List[List[int]], List[List[int]]]:
    """The ranks of every data group (one per (seq, model) position, in that
    order), of every model group (one per (data, seq) position) and of every
    seq group (one per (data, model) position) of a ``data × seq × model`` mesh."""
    def rank(d, s, m):
        return (d * seq + s) * model + m

    return ([[rank(d, s, m) for d in range(data)] for s in range(seq) for m in range(model)],
            [[rank(d, s, m) for m in range(model)] for d in range(data) for s in range(seq)],
            [[rank(d, s, m) for s in range(seq)] for d in range(data) for m in range(model)])


def make_mesh(cfg: MeshConfig = MeshConfig(), device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This rank's :class:`Mesh` over every rank of the default process group
    (one rank, no groups, without one). The data, model and (``seq > 1``) seq
    groups are made here, by every rank in the same order, so every rank must
    call it."""
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    model, seq = max(cfg.model, 1), max(cfg.seq, 1)
    data = cfg.data if cfg.data > 0 else world // (model * seq)
    if data * seq * model != world:
        shape = f"{data}x{model}" if seq == 1 else f"{data}x{seq}x{model} (data x seq x model)"
        raise ValueError(f"mesh {shape} != {world} ranks")
    dev = torch.device(device) if device is not None else (_DEVICE or torch.device("cuda"))
    mesh = Mesh(data, model, rank, dev, seq=seq)
    if not live:
        return mesh
    data_ranks, model_ranks, seq_ranks = axis_ranks(data, model, seq)
    data_groups = [dist.new_group(r) for r in data_ranks]
    model_groups = [dist.new_group(r) for r in model_ranks]
    seq_groups = [dist.new_group(r) for r in seq_ranks] if seq > 1 else [None] * len(seq_ranks)
    return dataclasses.replace(mesh, data_group=data_groups[mesh.s * model + mesh.m],
                               model_group=model_groups[mesh.d * seq + mesh.s],
                               seq_group=seq_groups[mesh.d * model + mesh.m])


# The registered mesh: the trainer registers its own before every step (and the
# CLI's ranks theirs), and BatchNorm, drop-path, the CCU, the losses and the
# attention router read it when they run, as the JAX routers read theirs at
# trace time. None: the one-process step.
_MESH: Optional[Mesh] = None
_ROWS: Optional[int] = None


def set_attention_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_attention_mesh() -> Optional[Mesh]:
    return _MESH


def data_group() -> Any:
    """The registered mesh's data group, or None (no mesh, or no process group)."""
    return None if _MESH is None else _MESH.data_group


@contextlib.contextmanager
def global_rows(n: int) -> Iterator[None]:
    """While open, :func:`global_batch` is ``n``: the real rows of a batch padded
    to a multiple of ``data`` (the eval forwards of ``evaluate/predict.py``)."""
    global _ROWS
    saved, _ROWS = _ROWS, n
    try:
        yield
    finally:
        _ROWS = saved


def global_batch(b: int) -> int:
    """The global batch behind a rank's local batch of ``b`` rows: ``b·data``
    under a registered mesh (the ranks' rows are equal), ``b`` without one."""
    if _MESH is None or _MESH.data == 1:
        return b
    return _ROWS if _ROWS is not None else b * _MESH.data


# -- collectives --------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its backward sums the gradient over the
    group (each rank's gradient is its own rows' share). Identity without a group."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of the model group's partial outputs of a row-parallel product;
    the backward passes the (replicated) gradient to each partial unchanged."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward for a replicated input of column-parallel products (or a
    shared parameter such as λ); the backward sums the heads' gradients over the group."""
    return x if group is None else _CopyToModel.apply(x, group)


def gather_cat(x: torch.Tensor, group: Any, parts: int, dim: int = 0) -> torch.Tensor:
    """Concatenate along ``dim``, in the order of their ranks, the equal pieces
    that the ``parts`` ranks of ``group`` hold, on every rank. No autograd."""
    if group is None or parts == 1:
        return x
    x = x.contiguous()
    pieces = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(pieces, x, group=group)
    return torch.cat(pieces, dim)


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.seq
        return x.narrow(dim, mesh.s * n, n)

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.mesh.seq_group, ctx.mesh.seq, ctx.dim), None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return gather_cat(x, mesh.seq_group, mesh.seq, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.s * ctx.n, ctx.n), None, None


def split_tokens(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The rank's block of the tokens (dim ``dim``, a multiple of ``seq``) of a
    tensor that every rank of its seq group holds whole; the backward gathers
    the ranks' gradients of their blocks over the group, so every rank gets
    the whole gradient."""
    return _SplitTokens.apply(x, mesh, dim)


def gather_tokens(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The seq group's token blocks concatenated on ``dim`` in seq order, on
    every rank; the backward takes the rank's block of the (replicated) gradient."""
    return _GatherTokens.apply(x, mesh, dim)


class RingPass:
    """One hop of the ring in flight (:func:`ring_pass`); :meth:`wait` returns
    the tensors received from the previous rank of the seq group."""

    def __init__(self, works, sent, received, device):
        self.works, self.sent, self.received, self.device = works, sent, received, device  # sent: alive until done

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        return [t.to(self.device) for t in self.received]


def ring_pass(tensors, mesh: Mesh, tag: int = 0) -> RingPass:
    """Start sending ``tensors`` to the next rank of the seq group (position
    s + 1, cyclically) and receiving the previous rank's (s − 1), the same
    shapes and dtypes, under tags ``tag``, ``tag + 1``, … (passes in flight
    together take tags apart). NCCL sends the device tensors; on a gloo group, whose
    ``send``/``recv`` read host memory, CUDA tensors are copied to the host
    first and the received ones back to the device in :meth:`RingPass.wait`."""
    staged = dist.get_backend(mesh.seq_group) == "gloo"
    send = [t.detach().contiguous() for t in tensors]
    device = send[0].device
    if staged:
        send = [t.cpu() for t in send]
    received = [torch.empty_like(t) for t in send]
    nxt = mesh.seq_ranks[(mesh.s + 1) % mesh.seq]
    prv = mesh.seq_ranks[(mesh.s - 1) % mesh.seq]
    ops = [dist.P2POp(dist.isend, t, peer=nxt, group=mesh.seq_group, tag=tag + i) for i, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, peer=prv, group=mesh.seq_group, tag=tag + i) for i, t in enumerate(received)]
    return RingPass(dist.batch_isend_irecv(ops), send, received, device)


def agree(values: torch.Tensor, group: Any = None) -> bool:
    """Whether every rank of ``group`` (the whole world when None) holds the same
    ``values``: one all-reduce of (x, −x) under MAX."""
    if not dist.is_initialized():
        return True
    both = torch.cat([values.reshape(-1), -values.reshape(-1)])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, neg_lo = both.chunk(2)
    return bool(torch.equal(hi, -neg_lo))


def broadcast_floats(values, device: torch.device, src: int = 0) -> List[float]:
    """Rank ``src``'s ``values`` (floats) on every rank (identity without a process group)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    if dist.is_initialized():
        dist.broadcast(t, src=src)
    return t.tolist()


# -- tensor-parallel sharding of the attention weights --------------------------

# (reference key suffix, dim, parts) of every head-sharded weight, as JAX's
# TP_ATTENTION_RULES shard them over 'model' (``cenet_tpu/core/mesh.py:167-175``),
# in torch's (out, in) layout: q/k/v and SRA's q/kv take their output rows
# (dim 0: JAX's columns), the output projections their input columns (dim 1:
# JAX's rows). ``parts`` 2: SRA's kv holds k and v stacked, and each half is
# split apart. The column-parallel biases go with their rows; the output
# projections' biases stay whole (added once after the all-reduce).
TP_ATTENTION_RULES: List[Tuple[str, int, int]] = [
    ("q_proj.weight", 0, 1), ("k_proj.weight", 0, 1), ("v_proj.weight", 0, 1), ("out_proj.weight", 1, 1),
    ("attn.q.weight", 0, 1), ("attn.q.bias", 0, 1), ("attn.kv.weight", 0, 2), ("attn.kv.bias", 0, 2),
    ("attn.proj.weight", 1, 1),
]

Plan = Dict[str, Tuple[int, int]]  # state_dict key → (dim, parts) of the sharded tensors


def tp_rule(key: str) -> Optional[Tuple[int, int]]:
    """(dim, parts) of ``key`` by ``TP_ATTENTION_RULES``, or None."""
    for suffix, dim, parts in TP_ATTENTION_RULES:
        if key == suffix or key.endswith("." + suffix):
            return dim, parts
    return None


def shard_tensor(t: torch.Tensor, dim: int, parts: int, index: int, count: int) -> torch.Tensor:
    """Piece ``index`` of ``count`` of ``t`` along ``dim``, each of its ``parts``
    stacked halves split apart (a contiguous copy)."""
    pieces = [p.chunk(count, dim)[index] for p in t.chunk(parts, dim)]
    return torch.cat(pieces, dim).contiguous()


def gather_tensor(t: torch.Tensor, dim: int, parts: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's :func:`shard_tensor` piece,
    on every rank of its model group."""
    pieces = [gather_cat(p, mesh.model_group, mesh.model, dim) for p in t.chunk(parts, dim)]
    return torch.cat(pieces, dim)


def _plan(keys, plan: Optional[Plan]) -> Plan:
    if plan is not None:
        return plan
    return {k: r for k in keys if (r := tp_rule(k)) is not None}


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh, plan: Optional[Plan] = None) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` (the reference's key names) with this rank's pieces
    of the sharded tensors: those of ``plan`` (the keys a model holds sharded,
    :func:`shard_model_`), or every key ``TP_ATTENTION_RULES`` names."""
    plan = _plan(full, plan)
    if mesh.model == 1:
        return dict(full)
    return {k: shard_tensor(v, *plan[k], mesh.m, mesh.model) if k in plan else v for k, v in full.items()}


def gather_state_dict(local: Dict[str, torch.Tensor], mesh: Mesh, plan: Optional[Plan] = None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`, on every rank of the model group."""
    plan = _plan(local, plan)
    if mesh.model == 1:
        return dict(local)
    return {k: gather_tensor(v, *plan[k], mesh) if k in plan else v for k, v in local.items()}


def shard_model_(model: torch.nn.Module, mesh: Mesh) -> Plan:
    """Give every head-sharded attention module of ``model`` whose heads divide
    ``mesh.model`` its rank's slice of the weights (``shard_heads_``); the others
    stay replicated. Returns the plan of the sharded keys."""
    plan: Plan = {}
    if mesh.model == 1:
        return plan
    for name, mod in model.named_modules():
        shard = getattr(mod, "shard_heads_", None)
        if shard is not None and shard(mesh):
            params = dict(mod.named_parameters())
            for k, rule in mod.TP_PLAN.items():
                if k in params:  # a bias-free projection has no bias to shard
                    plan[f"{name}.{k}" if name else k] = rule
    return plan
