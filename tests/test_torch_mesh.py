"""The port's mesh in one process: layout, rules, pieces, the global batch.

No process group and no JAX compile: the rank layout is held against the JAX
package's ``make_mesh`` on the 8-device CPU mesh, ``TP_ATTENTION_RULES``
against the JAX rules and the head-sharded modules' plans, the pieces of a
sharded tensor against the whole (k and v of SRA's kv split apart), and the
layers' view of the global batch (drop-path's rows, the CCU's skip) under a
registered mesh without a process group. The collectives run in
``tests/test_torch_dp.py``, ``tests/test_torch_tp.py`` and
``tests/test_torch_cli_mesh.py``.
"""

import jax
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu.core import mesh as jmesh
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn.cfam import CCU
from cenet_tpu_torch.nn.layers import DropPath

CPU = torch.device("cpu")


@pytest.fixture
def registered():
    """Register a mesh for one test and clear it after."""
    def register(mesh):
        M.set_attention_mesh(mesh)
        return mesh

    yield register
    M.set_attention_mesh(None)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_rank_layout_is_jax_make_mesh(data, model):
    """Rank r sits where JAX's ``make_mesh`` puts device r, and the data and
    model groups are the JAX mesh's columns and rows."""
    devices = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model)).devices
    ids = [[devices[d, m].id for m in range(model)] for d in range(data)]
    for rank in range(data * model):
        pos = M.Mesh(data, model, rank, CPU)
        assert ids[pos.d][pos.m] == rank
    data_ranks, model_ranks, seq_ranks = M.axis_ranks(data, model)
    assert data_ranks == [[ids[d][m] for d in range(data)] for m in range(model)]
    assert model_ranks == ids
    assert seq_ranks == [[r] for row in ids for r in row]  # one rank a seq group
    assert M.Mesh(data, model, data * model - 1, CPU).rows(8 * data) == slice(8 * data - 8, 8 * data)


@pytest.mark.parametrize("data,model,seq", [(4, 1, 2), (2, 2, 2), (1, 2, 4), (1, 1, 8)])
def test_rank_layout_with_seq_is_jax_make_mesh(data, model, seq):
    """With a seq axis rank r sits where JAX's ``make_mesh`` puts device r on
    its ``(data, seq, model)`` grid, and the three groups are its lines; the
    ranks of a seq group take the same rows."""
    devices = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model, seq=seq)).devices
    ids = {(d, s, m): devices[d, s, m].id for d in range(data) for s in range(seq) for m in range(model)}
    for rank in range(data * seq * model):
        pos = M.Mesh(data, model, rank, CPU, seq=seq)
        assert ids[(pos.d, pos.s, pos.m)] == rank
        assert pos.rows(4 * data) == slice(4 * pos.d, 4 * pos.d + 4)
    data_ranks, model_ranks, seq_ranks = M.axis_ranks(data, model, seq)
    assert data_ranks == [[ids[(d, s, m)] for d in range(data)] for s in range(seq) for m in range(model)]
    assert model_ranks == [[ids[(d, s, m)] for m in range(model)] for d in range(data) for s in range(seq)]
    assert seq_ranks == [[ids[(d, s, m)] for s in range(seq)] for d in range(data) for m in range(model)]


def test_seq_axis_raises_naming_its_item():
    """The seq axis ran only as a raise naming ROADMAP item 11b before its port;
    now a mesh with ``seq`` takes that many ranks (one process has too few), and
    the CLI's ``--mesh data,model,seq`` passes it on."""
    with pytest.raises(ValueError, match=r"mesh 1x2x1 \(data x seq x model\) != 1 ranks"):
        M.make_mesh(M.MeshConfig(data=1, model=1, seq=2), device="cpu")
    assert len(jmesh.make_mesh(jmesh.MeshConfig(data=2, model=1, seq=4)).axis_names) == 3  # JAX's 'seq' axis
    for text, want in (("2", (2, 1, 1)), ("2,2", (2, 2, 1)), ("4,1,1", (4, 1, 1)), ("2,1,2", (2, 1, 2)),
                       ("1,2,4", (1, 2, 4))):
        mcfg = cli._mesh_config(cli.build_argparser().parse_args(["train", "--preset", "acdc", "--mesh", text]))
        assert (mcfg.data, mcfg.model, mcfg.seq) == want


def test_rules_are_jax_rules_and_the_modules_plans():
    """Each JAX rule is a port rule (its columns are torch's dim 0, its rows
    dim 1); the port adds the column-parallel biases. On a CENet-b0 every key
    a rule names belongs to a head-sharded module whose plan names it alike."""
    port = {suffix: (dim, parts) for suffix, dim, parts in M.TP_ATTENTION_RULES}
    for path, spec in jmesh.TP_ATTENTION_RULES:
        dim = 0 if tuple(spec) == (None, "model") else 1
        assert port[path.replace("/", ".")][0] == dim
    assert set(port) - {p.replace("/", ".") for p, _ in jmesh.TP_ATTENTION_RULES} == {"attn.q.bias", "attn.kv.bias"}
    cfg = get_preset("acdc")
    cfg = cfg.replace(model=cfg.model.__class__(encoder="pvt_v2_b0", num_classes=4))
    model = build_model(cfg, device="cpu", seed=0)
    ruled = {k for k in model.state_dict() if M.tp_rule(k) is not None}
    planned = {}
    for name, mod in model.named_modules():
        params = dict(mod.named_parameters())
        for k, rule in getattr(mod, "TP_PLAN", {}).items():
            if k in params:
                planned[f"{name}.{k}"] = rule
    assert ruled == set(planned) and len(ruled) == 8 * 5 + 3 * 4  # 8 PVT-b0 blocks, 3 DSEBs
    assert all(M.tp_rule(k) == rule for k, rule in planned.items())


@pytest.mark.parametrize("count", [2, 4])
def test_pieces_cover_the_tensor(count):
    """The pieces of all ranks, concatenated per half, are the whole tensor:
    SRA's kv (k rows then v rows) splits each half apart."""
    g = torch.Generator().manual_seed(count)
    kv = torch.randn(2 * 16, 8, generator=g)
    pieces = [M.shard_tensor(kv, 0, 2, m, count) for m in range(count)]
    k, v = kv.chunk(2)
    for m, p in enumerate(pieces):
        assert torch.equal(p, torch.cat([k.chunk(count)[m], v.chunk(count)[m]]))
    proj = torch.randn(8, 16, generator=g)
    assert torch.equal(torch.cat([M.shard_tensor(proj, 1, 1, m, count) for m in range(count)], 1), proj)
    full = {"blk.attn.kv.weight": kv, "blk.attn.proj.weight": proj, "blk.norm.weight": torch.ones(8)}
    local = M.shard_state_dict(full, M.Mesh(1, count, 1, CPU))
    assert torch.equal(local["blk.attn.kv.weight"], pieces[1]) and local["blk.norm.weight"] is full["blk.norm.weight"]


def test_drop_path_draws_the_global_batch_and_takes_the_rank_rows(registered):
    """Rank d of ``data=2`` holding 4 rows draws the mask of the global 8 rows
    and keeps rows 4d … 4d+3: what the one process applies to those rows."""
    x = torch.arange(8.0)[:, None, None].expand(8, 3, 2).contiguous() + 1.0
    layer = DropPath(0.5).train()
    layer.generator = torch.Generator().manual_seed(11)
    want = layer(x)
    for d in range(2):
        registered(M.Mesh(2, 1, d, CPU))
        layer.generator.manual_seed(11)
        assert torch.equal(layer(x[4 * d : 4 * d + 4]), want[4 * d : 4 * d + 4])
        assert M.global_batch(4) == 8
        with M.global_rows(3):
            assert M.global_batch(2) == 3
    assert 0 < int((want == 0).all(dim=(1, 2)).sum()) < 8  # some rows dropped, some kept


def test_ccu_takes_the_global_batch(registered):
    """At one row a rank of ``data=2`` runs the CCU's BatchNorm, as the one
    process does at two rows; without a mesh one row skips it."""
    torch.manual_seed(0)
    ccu = CCU(8).eval()
    with torch.no_grad():
        ccu.bn.running_mean.uniform_(-1, 1)
        ccu.bn.running_var.uniform_(0.5, 2)
        x = torch.randn(2, 8, 5, 5)
        pair = ccu(x)
        alone = ccu(x[:1])
        registered(M.Mesh(2, 1, 0, CPU))
        ranked = ccu(x[:1])
    assert torch.equal(ranked, pair[:1]) and not torch.equal(alone, pair[:1])
    assert jax.device_count() == 8  # the JAX side ran on the virtual 8-device CPU mesh
