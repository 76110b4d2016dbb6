"""Ring attention of the port on the CPU: the ``seq`` mesh axis over gloo against JAX and one process.

Spawned once for the file (``tests/torch_mesh_ranks.py``), over gloo:

* two ranks on the (1, 1, 2) mesh run the ring core (``'ring'`` and
  ``'ring@seq'``) at ``tests/test_ring_attention.py``'s shapes, held against
  JAX's ring core on the 8-device CPU mesh with ``MeshConfig(data=4, seq=2)``
  (forward to atol/rtol 1e-5, dq, dk, dv to 2e-5: JAX's own limits); its
  fallbacks (N not a multiple of ``seq``, N ≠ M) equal to the plain core; the
  diff-attention route under both names against JAX's
  ``diff_attention_interleaved(..., impl='ring')`` with dλ; a
  ``MultiheadDiffAttn``, a ``Nonlocal`` and a stage-4 ``SRAAttention`` in
  train mode against the one-process modules; two fp32 SGD steps of CENet-b0
  at 64 px (``tests/test_torch_dp.py``'s configuration) against one process,
  under ``torch_mesh_ranks.relative_errors``' limits, ending with one state
  on both ranks; then ``cli train --mesh 1,1,2 --attn_impl ring`` for one
  step against ``cli train --attn_impl ring`` without a mesh, and ``cli eval
  --mesh 1,1,2`` of a seeded ``.pth`` against ``cli eval`` without a mesh;
* four ranks run the same modules on the (2, 1, 2) and (1, 2, 2) meshes
  (seq with data, seq with model), then ``cli train --mesh 2,1,2`` (one step,
  against the run without a mesh) and ``cli eval --mesh 1,2,2`` of a seeded
  ``.pth`` (against ``cli eval`` without a mesh).

Without a process group the fallbacks (no mesh; off-mesh above a shrunk
``_SMALL_LIMIT`` through ``chunked_attention_core``) run here, and
``chunked_attention_core`` is held against JAX's with a padded tail, and
``model_cost`` under the ring counts what every impl counts.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu.core import mesh as jmesh
from cenet_tpu.nn import attention as jatt
from cenet_tpu.ops import flash_attention as jflash
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.core.stats import model_cost
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.ops import router
from cenet_tpu_torch.tools.synthetic import write_acdc

FWD_TOL, GRAD_TOL = 1e-5, 2e-5  # tests/test_ring_attention.py's limits
MODULE_TOL = 2e-5  # of max |reference|, fp32
LOSS_RTOL, PARAM_ATOL = 2e-4, 5e-4
CLI_IMG = 32
IMPLS = ("ring@seq", "ring")
MESHES = [(2, 1, 2), (1, 2, 2)]  # (data, model, seq) of the four-rank run
# (port class, constructor kwargs, input shape, extra call args); 16 tokens a site
MODULES = [
    ("MultiheadDiffAttn", dict(embed_dim=32, depth=2, num_heads=2, attn_impl="ring"), (2, 16, 32), ()),
    ("Nonlocal", dict(dim=16, attn_impl="ring"), (2, 16, 4, 4), ()),
    ("SRAAttention", dict(dim=32, num_heads=2, qkv_bias=True, sr_ratio=1, attn_impl="ring"), (2, 16, 32), (4, 4)),
]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _qkv(rng, b=2, h=4, n=64, d=16, dv=24):
    return [rng.standard_normal(s).astype(np.float32) for s in ((b, h, n, d), (b, h, n, d), (b, h, n, dv))]


def _module_specs(rng):
    specs = []
    for seed, (kind, kw, shape, extra) in enumerate(MODULES):
        torch.manual_seed(seed)
        mod = R.build_module(kind, kw)
        with torch.no_grad():
            for p in mod.parameters():  # the blend and λ away from their initial values
                p.add_(0.1 * torch.randn_like(p))
        x = _t(rng.standard_normal(shape))
        out_shape = mod.train()(x, *extra).shape
        specs.append({"kind": kind, "kw": kw, "state": mod.state_dict(), "inputs": [x], "extra": extra,
                      "g": _t(rng.standard_normal(out_shape))})
    return specs


def _jax_core(cases):
    """JAX's ring core on the 8-device mesh (data 4, seq 2): (out, grads) per case."""
    out = []
    for impl, q, k, v, co in cases:
        core = jatt.get_attention_core(impl)
        grad = jax.jit(jax.grad(lambda q, k, v: jnp.sum(core(q, k, v) * co), argnums=(0, 1, 2)))
        out.append((np.asarray(core(q, k, v)), [np.asarray(g) for g in grad(q, k, v)]))
    return out


def _jax_diff(q, k, v, lam, co):
    def f(q, k, v, lam):
        return jflash.diff_attention_interleaved(q, k, v, lam, impl="ring")

    grad = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=(0, 1, 2, 3)))
    return np.asarray(f(q, k, v, lam)), [np.asarray(g) for g in grad(q, k, v, lam)]


def _cli_argv(root, out, *extra, mode="train"):
    return [mode, "--preset", "acdc", "--encoder", "pvt_v2_b0", "--device", "cpu", "--no-amp", "--root_path",
            str(root), "--list_dir", str(root), "--output_dir", str(out), "--batch_size", "2", "--max_epochs", "1",
            "--attn_impl", "ring", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    fwd, grads = _qkv(rng), _qkv(rng, n=32)
    core = [(impl, *qkv, rng.standard_normal(qkv[0].shape[:3] + (24,)).astype(np.float32))
            for impl, qkv in zip(IMPLS, (fwd, grads))]
    odd = _qkv(rng, n=31)
    fallback = [odd, [odd[0][:, :, :16], odd[1], odd[2]]]
    q, k = (rng.standard_normal((2, 4, 64, 8)).astype(np.float32) for _ in range(2))
    v, co = (rng.standard_normal((2, 2, 64, 16)).astype(np.float32) for _ in range(2))
    lam = np.float32(0.35)
    diff = [(impl, _t(q), _t(k), _t(v), torch.tensor(lam), _t(co)) for impl in IMPLS]
    specs = _module_specs(rng)
    root = tmp_path_factory.mktemp("ring")
    data = root / "data"
    write_acdc(str(data), n_train=2, n_valid=1, n_test=1, depth=2, h=48, w=40)
    args = {"core": [(impl, *map(_t, a)) for impl, *a in core], "fallback": [list(map(_t, f)) for f in fallback],
            "diff": diff, "modules": specs, "train": dict(attn_impl="ring"),
            "cli_img": CLI_IMG}
    with pytest.MonkeyPatch.context() as mp:  # seeded weights for the evals, as the CLI builds the model
        mp.setattr(tconfig, "get_preset", R.slim_preset(tconfig.get_preset, CLI_IMG))
        cfg = cli.make_config(cli.build_argparser().parse_args(_cli_argv(data, root)))
        torch.save({"state_dict": build_model(cfg, device="cpu", seed=7).state_dict()}, root / "w.pth")
    evals = [_cli_argv(data, root / name, "--checkpoint", str(root / "w.pth"), *extra, mode="eval")
             for name, extra in (("eval122", ("--mesh", "1,2,2")), ("eval_one", ()), ("eval112", ("--mesh", "1,1,2")))]
    args.update(cli=[_cli_argv(data, root / "mesh", "--mesh", "1,1,2"), evals[2]],
                cli_ports=[M.free_port(), M.free_port()])
    four_cli = [_cli_argv(data, root / "mesh212", "--mesh", "2,1,2"), evals[0]]
    two = R.start_ranks("rank_ring", 2, args)
    four = R.start_ranks("rank_ring_modules", 4, {"modules": specs, "meshes": MESHES, "cli": four_cli,
                                                  "cli_ports": [M.free_port(), M.free_port()], "cli_img": CLI_IMG})
    try:
        jm = jmesh.make_mesh(jmesh.MeshConfig(data=4, seq=2))
        jmesh.set_attention_mesh(jm)
        try:
            jax_core = _jax_core([(impl, *map(jnp.asarray, a)) for impl, *a in core])
            jax_diff = _jax_diff(*map(jnp.asarray, (q, k, v, lam, co)))
        finally:
            jmesh.set_attention_mesh(None)
        alone = []
        for spec in specs:
            mod = R.build_module(spec["kind"], spec["kw"]).train()
            mod.load_state_dict(spec["state"], strict=True)
            out, gx, gp = R.run_module(mod, spec)
            alone.append((out, gx, gp))
        ref = R.train(R.dp_config(attn_impl="ring"))
        cost = model_cost(build_model(R.dp_config(), device="cpu", seed=0), (1, 1, 64, 64))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tconfig, "get_preset", R.slim_preset(tconfig.get_preset, CLI_IMG))
            with contextlib.redirect_stdout(io.StringIO()):
                cli_one = cli.main(_cli_argv(data, root / "one")).state_dict()
                eval_one = cli.main(evals[1])
    finally:
        got2, got4 = two.results(), four.results()
    return {"core": core, "jax_core": jax_core, "fallback": fallback, "diff": diff, "jax_diff": jax_diff,
            "alone": alone, "ref": ref, "cost": cost, "cli_one": cli_one, "eval_one": eval_one, "two": got2,
            "four": got4, "mesh_out": root / "mesh"}


def test_seq_ranks_sit_where_jax_puts_them(runs):
    assert [r["place"] for r in runs["two"]] == [(0, 0, 0, [0, 1]), (0, 1, 0, [0, 1])]


@pytest.mark.parametrize("case", range(2), ids=["ring@seq-n64", "ring-n32"])
def test_ring_core_matches_jax_ring(runs, case):
    """Forward and dq, dk, dv, as ``tests/test_ring_attention.py`` takes them:
    ``'ring@seq'`` at 64 tokens, ``'ring'`` at 32."""
    want_out, want_grads = runs["jax_core"][case]
    for rank in runs["two"]:
        out, grads = rank["core"][case]
        np.testing.assert_allclose(out.numpy(), want_out, atol=FWD_TOL, rtol=FWD_TOL)
        for name, g, w in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [0, 1], ids=["n_not_a_multiple_of_seq", "n_not_m"])
def test_ring_fallbacks_are_the_plain_core(runs, case):
    want = router.plain_attention(*map(_t, runs["fallback"][case]))
    for rank in runs["two"]:
        assert torch.equal(rank["fallback"][case], want)


def test_ring_without_a_mesh_is_the_plain_core():
    q, k, v = map(_t, _qkv(np.random.default_rng(1)))
    M.set_attention_mesh(None)
    for impl in IMPLS:
        assert torch.equal(tatt.get_attention_core(impl)(q, k, v), router.plain_attention(q, k, v))


def test_ring_off_the_mesh_above_the_limit_takes_query_blocks(monkeypatch):
    """Above a shrunk ``_SMALL_LIMIT`` the fallback is ``chunked_attention_core``
    (the JAX core's choice), here 600 tokens in blocks of 512 and a padded tail."""
    rng = np.random.default_rng(2)
    q, k, v = map(_t, _qkv(rng, b=1, h=1, n=600, d=8, dv=8))
    M.set_attention_mesh(None)
    calls = []
    chunked = router.chunked_attention_core
    monkeypatch.setattr(router, "chunked_attention_core", lambda *a: calls.append(1) or chunked(*a))
    monkeypatch.setattr(router, "_SMALL_LIMIT", 1024)
    got = tatt.get_attention_core("ring")(q, k, v)
    assert calls == [1] and torch.equal(got, chunked(q, k, v))
    assert (got - router.plain_attention(q, k, v)).abs().max() < 1e-6


@pytest.mark.parametrize("n, q_chunk", [(40, 16), (600, 512)])
def test_chunked_core_matches_jax(n, q_chunk):
    """Forward and gradients of ``chunked_attention_core`` against JAX's, with a padded tail."""
    rng = np.random.default_rng(n)
    q, k, v = _qkv(rng, b=1, h=2, n=n, d=8, dv=12)
    co = rng.standard_normal((1, 2, n, 12)).astype(np.float32)
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = router.chunked_attention_core(*xs, q_chunk=q_chunk)
    (out * _t(co)).sum().backward()
    f = jax.jit(lambda q, k, v: jflash.chunked_attention_core(q, k, v, q_chunk=q_chunk))
    want = f(q, k, v)
    want_g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=(0, 1, 2)))(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    for name, x, w in zip("qkv", xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [0, 1], ids=IMPLS)
def test_diff_attention_ring_route_matches_jax(runs, case):
    want_out, want_grads = runs["jax_diff"]
    for rank in runs["two"]:
        out, grads = rank["diff"][case]
        np.testing.assert_allclose(out.numpy(), want_out, atol=FWD_TOL, rtol=FWD_TOL)
        for name, g, w in zip(("q", "k", "v", "lam"), grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


def _close(got, want, where, scale=None):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= MODULE_TOL * (want.abs().max().item() if scale is None else scale), (where, err)


@pytest.mark.parametrize("mesh", [(1, 1, 2)] + MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("i", range(len(MODULES)), ids=[m[0] for m in MODULES])
def test_ring_modules_match_one_process(runs, mesh, i):
    """Each module on the mesh against the one-process module: the rank's rows
    of the output and input gradients, each within 2e-5 of its largest value,
    and the whole parameter gradients, within 2e-5 of the module's largest
    (``Nonlocal``'s φ bias shifts every logit of a row alike: its gradient is
    rounding noise)."""
    data, model, seq = mesh
    ranks = [r["modules"][i] for r in runs["two"]] if mesh == (1, 1, 2) else [r[mesh][i] for r in runs["four"]]
    want_out, want_gx, want_gp = runs["alone"][i]
    b = want_out.shape[0] // data
    for rank, (out, gx, gp, sharded) in enumerate(ranks):
        d = rank // (seq * model)
        rows = slice(d * b, (d + 1) * b)
        _close(out, want_out[rows], (mesh, rank, "out"))
        _close(gx[0], want_gx[0][rows], (mesh, rank, "input grad"))
        assert set(gp) == set(want_gp)
        largest = max(g.abs().max().item() for g in want_gp.values())  # conv_phi's bias: rounding noise
        for k in want_gp:
            _close(gp[k], want_gp[k], (mesh, rank, k), largest)
        assert sharded == (model > 1 and MODULES[i][0] != "Nonlocal")


def test_ring_train_steps_match_one_process(runs):
    ref, (r0, r1) = runs["ref"], (r["train"] for r in runs["two"])
    for run in (r0, r1):
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=LOSS_RTOL)
        sd, want = run["state"]["state_dict"], ref["state"]["state_dict"]
        assert max((sd[k].double() - want[k].double()).abs().max().item() for k in want) < PARAM_ATOL
        errs = R.relative_errors(run["state"], ref["state"], ref["init"])
        assert max(errs["update"][0], errs["slot"][0]) < R.WHOLE_RTOL, errs
        assert max(errs["update"][1], errs["slot"][1]) < R.TENSOR_RTOL, errs
        assert run["impl"] == "ring" and run["state"]["optimizer"]["count"] == 2
    for k in r0["state"]["state_dict"]:  # the seq ranks hold one state
        assert torch.equal(r0["state"]["state_dict"][k], r1["state"]["state_dict"][k]), k


def test_cli_train_on_the_seq_mesh_matches_one_process(runs):
    one = runs["cli_one"]
    (c0, c1) = (r["cli"][0] for r in runs["two"])
    assert c0["impl"] == "ring" and c0["state"]["optimizer"]["count"] == one["optimizer"]["count"] == 1
    for k, want in one["state_dict"].items():
        assert torch.equal(c0["state"]["state_dict"][k], c1["state"]["state_dict"][k]), k
        assert (c0["state"]["state_dict"][k].double() - want.double()).abs().max().item() < PARAM_ATOL, k
    (snap,) = os.listdir(runs["mesh_out"])
    with open(os.path.join(runs["mesh_out"], snap, "log_train.txt")) as fh:
        assert fh.read().count("mesh: data=1 model=1 seq=2") == 1
    assert c1["printed"] == ""  # rank 1 prints nothing


def test_model_cost_under_the_ring_is_every_impls(runs):
    """``model_cost`` with ``attn_impl='ring'`` under the seq mesh counts what
    'pallas' counts without one (``meta`` tensors take the plain fallback), and
    calls no collective."""
    for rank in runs["two"]:
        cost, called = rank["cost"]
        assert cost == runs["cost"] and called == []


def test_cli_train_and_eval_on_seq_with_data_and_with_model(runs):
    """``cli train --mesh 2,1,2`` (four ranks, each of the two data ranks one
    row) ends where ``cli train`` without a mesh ends, on every rank; ``cli
    eval --mesh 1,2,2`` of a seeded ``.pth`` (the diff-attention and SRA
    sites head-sharded, the ring on their rank's heads) prints the JSON of
    ``cli eval`` without a mesh within 1e-6 (fp32), and so does every rank."""
    one = runs["cli_one"]
    train = [r["cli"][0] for r in runs["four"]]
    for rank in train:
        assert rank["impl"] == "ring" and rank["state"]["optimizer"]["count"] == one["optimizer"]["count"]
        for k, want in one["state_dict"].items():
            assert (rank["state"]["state_dict"][k].double() - want.double()).abs().max().item() < PARAM_ATOL, k
    evals = [r["cli"][1] for r in runs["four"]]
    got, want = evals[0]["result"], runs["eval_one"]
    assert set(got) == set(want) == {"mean_dice", "mean_hd95"}
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want), (got, want)
    assert all(e["result"] == got for e in evals) and [e["printed"] == "" for e in evals] == [False, True, True, True]


def test_cli_eval_on_the_seq_mesh_matches_one_process(runs):
    """``cli eval --mesh 1,1,2 --attn_impl ring`` (fp32) of a seeded ``.pth``
    prints the JSON of ``cli eval`` without a mesh within 1e-6, on both ranks;
    rank 1 prints nothing."""
    e0, e1 = (r["cli"][1] for r in runs["two"])
    want = runs["eval_one"]
    assert set(e0["result"]) == set(want) == {"mean_dice", "mean_hd95"}
    assert all(abs(e0["result"][k] - want[k]) <= 1e-6 for k in want), (e0["result"], want)
    assert e1["result"] == e0["result"] and e0["printed"] != "" and e1["printed"] == ""
