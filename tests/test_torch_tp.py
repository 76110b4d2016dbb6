"""Tensor parallelism of the port on the CPU: the head-sharded attention and the meshed step.

Spawned once for the file (``tests/torch_mesh_ranks.py``), over gloo:

* two ranks on a (1, 2) mesh hold the head-sharded ``SRAAttention`` at a
  site whose heads divide (2 heads, ``sr_ratio`` 2) and one whose heads do
  not (5 heads, replicated), and ``MultiheadDiffAttn`` (2 heads, one
  interleaved pair a rank), all under ``'xla@model'``, with seeded weights
  that the JAX modules take too; the JAX modules run under ``'xla@model'`` on a 1×2 CPU
  mesh (``shard_map`` over the heads, small jitted modules). Outputs, input
  gradients and every parameter's gradient (the sharded ones gathered) agree
  within 2e-5 of the largest value, and so do those gradients as the
  optimizer clips them to a global norm below theirs (the sharded pieces'
  squares summed over the group) against the JAX gradients clipped whole.
  ``MultiheadDiffAttnCross`` is held
  against itself without a mesh, and the full state goes onto the mesh and
  comes back unchanged, k and v of SRA's kv each split apart;
* 2 SGD steps of CENet-b0 at 64 px (``tests/test_torch_dp.py``'s
  configuration) on ``model=2`` (two ranks) and ``data=2 × model=2`` (four
  ranks) against one process: losses to rtol 2e-4, parameters and statistics
  to 5e-4 max-abs, the optimizer's slots too, and the parameter updates and
  slots within 1e-3 of their whole norm and 1e-2 of each tensor's
  (``torch_mesh_ranks.relative_errors``: the gradient path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
import torch_parity as tp
from cenet_tpu.core.mesh import MeshConfig as JMeshConfig
from cenet_tpu.core.mesh import make_mesh as jmake_mesh
from cenet_tpu.core.mesh import set_attention_mesh as jset_mesh
from cenet_tpu.nn import attention as jatt
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.nn import attention as tatt

MODULE_TOL = 2e-5  # of max |reference|: fp32, the row-parallel sum split over the ranks
LOSS_RTOL, PARAM_ATOL = 2e-4, 5e-4
TRAIN = {"model2": (dict(loss_type="boundary"), (1, 2)),
         "data2_model2": (dict(loss_type="dice,ce", loss_weights="0.5,0.5"), (2, 2))}

# (name, port class, constructor kwargs, JAX module, inputs (B, N, C) and the extra call args)
MODULES = [
    ("sra_2_heads", "SRAAttention", dict(dim=32, num_heads=2, qkv_bias=True, sr_ratio=2), (2, 64, 32), (8, 8)),
    ("sra_5_heads", "SRAAttention", dict(dim=40, num_heads=5, qkv_bias=True, sr_ratio=1), (2, 16, 40), (4, 4)),
    ("diff_2_heads", "MultiheadDiffAttn", dict(embed_dim=32, depth=2, num_heads=2), (2, 16, 32), ()),
]


def _module_specs(rng):
    """Each module of ``MODULES``: the port's, with seeded weights, as the ranks
    rebuild it, and the JAX module with the same weights (``variables_from_port``
    over a ``jax.eval_shape`` template: no init compile)."""
    specs, jax_side = [], []
    for seed, (name, kind, kw, shape, extra) in enumerate(MODULES):
        x = tp.rand32(rng, *shape)
        jm = getattr(jatt, kind)(**kw, attn_impl="xla@model")
        template = jax.eval_shape(lambda jm=jm, x=x, extra=extra: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *extra))
        torch.manual_seed(seed)
        port = getattr(tatt, kind)(**kw, attn_impl="xla@model")
        variables = tp.variables_from_port(port, {"params": jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                                                          template["params"])})
        g = tp.rand32(rng, *port(torch.from_numpy(x), *extra).shape)
        specs.append({"kind": kind, "kw": {**kw, "attn_impl": "xla@model"}, "state": port.state_dict(),
                      "inputs": [torch.from_numpy(x)], "extra": extra, "g": torch.from_numpy(g)})
        jax_side.append((jm, variables, x, extra, g))
    return specs, jax_side


def _jax_reference(jm, variables, x, extra, g):
    """Output, input gradient and parameter gradients of the JAX module under
    ``'xla@model'`` on a 1×2 mesh of the CPU's virtual devices."""
    jset_mesh(jmake_mesh(JMeshConfig(data=1, model=2), devices=jax.devices()[:2]))
    try:
        def run(params, x, g):
            out, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x, *extra), params, x)
            gp, gx = vjp(g)
            return out, gx, gp

        out, gx, gp = jax.jit(run)(variables["params"], jnp.asarray(x), jnp.asarray(g))
    finally:
        jset_mesh(None)
    grads = state_dict_from_jax({"params": {"m": jax.tree.map(np.asarray, gp)}})
    return np.asarray(out), np.asarray(gx), {k[len("m."):]: v for k, v in grads.items()}


def _cross_spec(rng):
    kw = dict(embed_dim=32, depth=1, num_heads=2, attn_impl="chunked@model")
    torch.manual_seed(7)
    mod = tatt.MultiheadDiffAttnCross(**kw)
    x, q = torch.from_numpy(tp.rand32(rng, 2, 16, 32)), torch.from_numpy(tp.rand32(rng, 2, 16, 32))
    return {"kind": "MultiheadDiffAttnCross", "kw": kw, "state": mod.state_dict(), "inputs": [x, q],
            "g": torch.from_numpy(tp.rand32(rng, 2, 16, 32))}


def _full_state(rng):
    """A state under the reference's key names with a PVT block's SRA and a DSEB's diff attention."""
    shapes = {"attn.q.weight": (16, 16), "attn.q.bias": (16,), "attn.kv.weight": (32, 16), "attn.kv.bias": (32,),
              "attn.proj.weight": (16, 16), "attn.proj.bias": (16,), "diffattn.q_proj.weight": (16, 16),
              "diffattn.k_proj.weight": (16, 16), "diffattn.v_proj.weight": (16, 16),
              "diffattn.out_proj.weight": (16, 16), "diffattn.lambda_q1": (4,), "norm.weight": (16,)}
    return {k: torch.from_numpy(tp.rand32(rng, *s)) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def runs():
    four = R.start_ranks("rank_train", 4, {"cases": [TRAIN["data2_model2"]]})
    rng = np.random.default_rng(0)
    specs, jax_side = _module_specs(rng)
    cross, full = _cross_spec(rng), _full_state(rng)
    args = {"modules": specs, "unsharded": [cross], "full_state": full}
    two = R.start_ranks("rank_tp", 2, {**args, "cases": [TRAIN["model2"]]})
    try:
        jax_refs = [_jax_reference(*j) for j in jax_side]
        refs = {name: R.train(R.dp_config(**kw)) for name, (kw, _) in TRAIN.items()}
    finally:
        got2, got4 = two.results(), four.results()
    return {"jax": jax_refs, "refs": refs, "two": got2, "four": got4, "full": full}


def _close(got, want, what):
    got, want = (t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (got, want))
    err = np.abs(got - want).max()
    assert err <= MODULE_TOL * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


@pytest.mark.parametrize("i", range(len(MODULES)), ids=[m[0] for m in MODULES])
def test_head_sharded_module_matches_jax_at_model(runs, i):
    out, gx, gp = runs["jax"][i]
    for rank, result in enumerate(runs["two"]):
        sharded, got_out, got_gx, got_gp, _ = result["modules"][i]
        assert sharded == (MODULES[i][2].get("num_heads") % 2 == 0)
        _close(got_out, out, f"rank {rank} out")
        _close(got_gx[0], gx, f"rank {rank} dx")
        assert set(got_gp) == set(gp)
        for k in gp:
            _close(got_gp[k], gp[k], f"rank {rank} d{k}")


@pytest.mark.parametrize("i", range(len(MODULES)), ids=[m[0] for m in MODULES])
def test_clip_norm_counts_each_sharded_piece_once(runs, i):
    """The optimizer's global-norm clip over the head-sharded module's
    gradients (the sharded pieces' squares summed over the model group, the
    replicated gradients counted once) scales them as one process clips the
    JAX module's whole gradients."""
    _, _, gp = runs["jax"][i]
    norm = sum(float(v.double().square().sum()) for v in gp.values()) ** 0.5
    assert norm > R.CLIP  # the clip is active
    for rank, result in enumerate(runs["two"]):
        got = result["modules"][i][4]
        assert set(got) == set(gp)
        for k in gp:
            _close(got[k], gp[k] * (R.CLIP / norm), f"rank {rank} clipped d{k}")


def test_cross_attention_shards_without_changing_its_math(runs):
    """``MultiheadDiffAttnCross`` under ``'chunked@model'``: whole weights with
    each core on the rank's heads (``router.shard_heads``), and its own
    head-sharded weights, both equal to the module without a mesh, in the
    output and both inputs' gradients."""
    for result in runs["two"]:
        sharded, (out, grads), *meshed = result["unsharded"][0]
        assert sharded
        for out_tp, grads_tp in meshed:
            _close(out_tp, out, "out")
            for a, b in zip(grads_tp, grads):
                _close(a, b, "d input")


def test_state_goes_onto_the_mesh_and_back(runs):
    full = runs["full"]
    for m, result in enumerate(runs["two"]):
        assert result["round_trip"]
        k, v = full["attn.kv.weight"].chunk(2)
        assert torch.equal(result["local_kv"], torch.cat([k.chunk(2)[m], v.chunk(2)[m]]))
        shapes = result["local_keys"]
        assert shapes["attn.q.weight"] == (8, 16) and shapes["attn.q.bias"] == (8,)
        assert shapes["attn.proj.weight"] == (16, 8) and shapes["attn.proj.bias"] == (16,)
        assert shapes["diffattn.out_proj.weight"] == (16, 8) and shapes["diffattn.lambda_q1"] == (4,)
        assert shapes["norm.weight"] == (16,)


def _max_diff(a, b):
    return max((a[k].double() - b[k].double()).abs().max().item() for k in a)


@pytest.mark.parametrize("case", list(TRAIN))
def test_tp_step_matches_one_process(runs, case):
    want_losses, want = runs["refs"][case]["losses"], runs["refs"][case]["state"]
    results = runs["two"] if case == "model2" else runs["four"]
    for result in results:
        run = result["train"][0]
        losses, state = run["losses"], run["state"]
        assert run["impl"] == "pallas@model"  # the JAX Trainer's tag under a model axis
        assert len(run["plan"]) == 32  # PVT-b0 stages 2 and 4 (2 and 8 heads), the three DSEBs; not 1 and 3
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        assert {k: v.shape for k, v in state["state_dict"].items()} == {k: v.shape for k, v in want["state_dict"].items()}
        assert _max_diff(state["state_dict"], want["state_dict"]) < PARAM_ATOL
        errs = R.relative_errors(state, want, runs["refs"][case]["init"])  # the gradient path: updates and slots
        assert max(errs["update"][0], errs["slot"][0]) < R.WHOLE_RTOL, errs
        assert max(errs["update"][1], errs["slot"][1]) < R.TENSOR_RTOL, errs
        slots = {n: s["trace"] for n, s in state["optimizer"]["state"].items()}
        assert _max_diff(slots, {n: s["trace"] for n, s in want["optimizer"]["state"].items()}) < PARAM_ATOL


def test_a_trainer_registers_its_mesh():
    """``Trainer(mesh=…)`` registers its mesh (here a one-process mesh, without
    a model axis, so no tag), a trainer without one clears it, and a mesh that
    does not cover the process group's ranks raises."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.train.trainer import Trainer

    mesh = M.Mesh(data=1, model=1, rank=0, device=torch.device("cpu"))
    assert Trainer(R.dp_config(), 1, mesh=mesh).cfg.model.attn_impl == "pallas"
    assert M.get_attention_mesh() is mesh
    Trainer(R.dp_config(), 1, device="cpu")
    assert M.get_attention_mesh() is None
    with pytest.raises(ValueError, match="mesh 1x2 != 1 ranks"):
        M.make_mesh(M.MeshConfig(data=1, model=2), device="cpu")
