"""The Orbax bridge on the CPU: the JAX package's checkpoints read without JAX.

``cenet_tpu_torch/core/orbax.py`` reads what the JAX package's
``CheckpointManager`` writes (OCDBT, zarr v2, zstd), ``train_state_from_jax``
maps the TrainState onto the port's ``Trainer.state_dict()``, and
``core/checkpoint.py`` puts both behind ``load_checkpoint``,
``CheckpointManager.restore``, ``cli eval --checkpoint`` and ``cli train
--resume``. Held here:

* the reader equals Orbax's own restore to the bit (values, dtypes, and the
  tree Orbax gives back without a target), for trees with scalars, ``None``,
  empty tuples and dicts, nested dicts and lists, several dtypes, arrays cut
  into many chunks by a small ``chunk_byte_size``, and the
  ``steps/<n>/default`` layout; the OCDBT layer equals TensorStore's listing
  of a database with interior nodes and indirect values;
* the committed fixture ``tests/torch_orbax_data`` (``torch_orbax_fixture.py``:
  the Synapse CENet-b2 TrainState, full width, as step 37): it equals its
  manifest's hashes and ``restore_tag_dir``, and it maps onto the port's 801
  tensors and 630 momentum slots at count 37 in a process that imports no
  JAX, Orbax, TensorStore or ``zstandard``;
* a corrupted node, a truncated data file, zarr v3 and an unknown compressor
  raise ``ValueError`` naming them;
* ``train_state_from_jax`` of a slim CENet-b0 TrainState (seeded non-zero
  slots) for SGD, Adam and AdamW, each with ``grad_clip`` and ``freeze_bb``,
  is the mapped tree to the bit, and loads into the port's trainer;
* one port step from a trainer restored from Orbax equals one from the same
  state loaded from ``.pth``, to the bit;
* ``cli eval --checkpoint <Orbax tag> --device cpu`` prints what the same
  weights as ``.npz`` print; ``cli train --resume`` over a JAX-written
  snapshot resumes at the JAX ``it`` and epoch, and the two formats' tags and
  steps follow one rule (the ``.pth`` wins a tie).
"""

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu.core import checkpoint as jckpt
from cenet_tpu.core import config as jconfig
from cenet_tpu.train.trainer import Trainer as JTrainer
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.convert.jax2torch import _to_torch_layout, torch_names, train_state_from_jax
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core.checkpoint import (CheckpointManager, load_checkpoint, load_train_state,
                                             snapshot_checkpoint)
from cenet_tpu_torch.core.orbax import OcdbtDatabase, read_checkpoint
from cenet_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_orbax_data")
IMG, ENCODER = 64, "pvt_v2_b0"


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]


def assert_same_tree(got, want):
    """Equal structure (dicts, lists, None, empty containers) and leaves to the bit."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if a is None:
            assert b is None, path
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), jax.tree_util.keystr(path)


def _save(path, tree, save_args=None):
    c = ocp.StandardCheckpointer()
    c.save(str(path), tree, save_args=save_args)
    c.wait_until_finished()


@pytest.mark.parametrize("layout", ["tag", "steps"])
def test_reader_equals_orbax_restore(tmp_path, layout):
    rng = np.random.default_rng(0)
    tree = {
        "params": {"a": {"kernel": rng.standard_normal((37, 50, 3)).astype(np.float32),
                         "bias": np.zeros(50, np.float32)},
                   "b": np.float32(2.5), "h": rng.standard_normal((3, 5)).astype(np.float16)},
        "batch_stats": {},
        "opt_state": [None, {"x": np.arange(1000, dtype=np.int64), "f": rng.random(9)}, (), [np.int32(7)]],
        "flags": np.array([True, False, True]), "bytes": rng.integers(0, 255, (4, 4), dtype=np.uint8),
        "step": np.int32(37),
    }
    if layout == "tag":  # many chunks: 2 KiB of the (37, 50, 3) array and of the int64 vector each
        save_args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=2048), tree)
        _save(tmp_path / "t", tree, save_args)
        path = tmp_path / "t"
        assert sum(k.startswith(b"params.a.kernel/") for k in OcdbtDatabase(str(path)).entries) > 20
    else:  # the JAX package's own manager: <snap>/steps/<n>/default
        jckpt.CheckpointManager(str(tmp_path / "snap")).save(37, tree)
        path = tmp_path / "snap" / "steps" / "37"
    got = read_checkpoint(str(path))
    assert_same_tree(got, ocp.StandardCheckpointer().restore(str(path / "default" if layout == "steps" else path)))
    assert got["opt_state"][2] == () and got["opt_state"][0] is None and got["batch_stats"] == {}
    assert read_checkpoint(str(path), select=["step"]) == {"step": np.int32(37)}


def test_ocdbt_database_matches_tensorstore(tmp_path):
    """Small nodes (interior levels) and a small inline limit (values in data files)."""
    base = f"file://{tmp_path}/db"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base,
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20}}).result()
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn)[f"key/{i:03d}/{'x' * (i % 5)}"] = bytes([i]) * (3 + 5 * i)
    db = OcdbtDatabase(str(tmp_path / "db"))
    keys = ts.KvStore.open({"driver": "ocdbt", "base": base}).result().list().result()
    assert sorted(db.entries) == sorted(keys) and len(keys) == 60
    assert sum(isinstance(v, tuple) for v in db.entries.values()) > 40  # indirect
    for k in keys:
        assert db.get(k.decode()) == kv.read(k).result().value


def _get(tree, path):
    for p in path.split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def test_committed_fixture_equals_its_manifest_and_orbax():
    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        manifest = json.load(f)
    step = os.path.join(FIXTURE, "steps", str(manifest["step"]))
    tree = read_checkpoint(step)
    for r in manifest["leaves"]:
        a = _get(tree, r["path"])
        assert list(a.shape) == r["shape"] and a.dtype.name == r["dtype"], r["path"]
        assert hashlib.sha256(a.tobytes()).hexdigest() == r["sha256"], r["path"]
    assert len(manifest["leaves"]) == 1376 and int(tree["step"]) == manifest["step"] == 37
    assert_same_tree(tree, jckpt.restore_tag_dir(os.path.join(step, "default"), tree))  # Orbax's own read
    code = ("import sys, cenet_tpu_torch.core.checkpoint as C, cenet_tpu_torch.core.config as G; "
            f"s = C.load_train_state({step!r}, G.get_preset('synapse')); "
            "print(len(s['state_dict']), len(s['optimizer']['state']), s['optimizer']['count'], sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cenet_tpu', 'orbax', 'tensorstore', "
            "'zstandard')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().split(maxsplit=3)
    assert out == ["801", "630", "37", "[]"]


def test_bad_checkpoints_raise_naming_the_fault(tmp_path):
    tree = {"params": {"w": np.arange(4000, dtype=np.float32)}, "step": np.int32(1)}
    _save(tmp_path / "ok", tree)
    node = next(os.path.join(d, n) for d, _, ns in os.walk(tmp_path / "ok" / "d") for n in ns)
    bad = tmp_path / "crc"
    shutil.copytree(tmp_path / "ok", bad)
    raw = bytearray(open(node, "rb").read())
    raw[20] ^= 1
    open(bad / os.path.relpath(node, tmp_path / "ok"), "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        read_checkpoint(str(bad))
    short = tmp_path / "short"
    shutil.copytree(tmp_path / "ok", short)
    with open(short / os.path.relpath(node, tmp_path / "ok"), "r+b") as f:
        f.truncate(len(raw) // 2)
    with pytest.raises(ValueError, match="past its end|truncated|shorter"):
        read_checkpoint(str(short))
    c = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))
    c.save(str(tmp_path / "z3"), tree)
    c.close()
    with pytest.raises(ValueError, match="zarr v3"):
        read_checkpoint(str(tmp_path / "z3"))
    # a zarr array compressed with blosc, under Orbax's tree metadata
    blosc = tmp_path / "blosc"
    shutil.copytree(tmp_path / "ok", blosc, ignore=shutil.ignore_patterns("d", "ocdbt.process_*", "manifest.ocdbt"))
    ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{blosc}", "path": "params.w/"},
             "metadata": {"shape": [4000], "chunks": [4000], "dtype": "<f4",
                          "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}},
             "create": True}).result().write(tree["params"]["w"]).result()
    with pytest.raises(ValueError, match="compressor 'blosc'"):
        read_checkpoint(str(blosc), select=["params"])


def _jax_cfg(optimizer="sgd", grad_clip=0.0, freeze_bb=False):
    cfg = jconfig.get_preset("synapse")
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder=ENCODER, freeze_bb=freeze_bb),
                       train=dataclasses.replace(cfg.train, optimizer=optimizer, grad_clip=grad_clip),
                       data=dataclasses.replace(cfg.data, img_size=IMG))


def _port_cfg(jcfg):
    cfg = tconfig.get_preset("synapse")
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder=ENCODER, freeze_bb=jcfg.model.freeze_bb,
                                                 drop_path_rate=0.0),
                       train=dataclasses.replace(cfg.train, optimizer=jcfg.train.optimizer,
                                                 grad_clip=jcfg.train.grad_clip, amp=False),
                       data=dataclasses.replace(cfg.data, img_size=IMG))


@functools.lru_cache(maxsize=None)
def _abstract_variables():
    """The slim model's variables as ``jax.eval_shape`` gives them (no
    compile; the optimizer and ``freeze_bb`` do not change them)."""
    jt = JTrainer(_jax_cfg(), max_iterations=100)
    return jax.eval_shape(lambda k: jt.model.init(k, jnp.zeros((1, IMG, IMG, 1)), train=False),
                          jax.random.PRNGKey(0))


def _jax_state(jcfg, step=6, seed=0):
    """The JAX ``Trainer``'s TrainState tree for ``jcfg`` (as ``init_state``
    builds it, on ``jax.eval_shape``), every leaf seeded: weights and slots
    non-zero, ``nu`` and the variances positive, counts and ``step`` equal to
    ``step``."""
    jt = JTrainer(jcfg, max_iterations=100)
    variables = _abstract_variables()
    abstract = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "opt_state": jax.eval_shape(jt.tx.init, variables["params"])}
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        if np.issubdtype(leaf.dtype, np.integer):
            return np.full(leaf.shape, step, leaf.dtype)
        x = rng.standard_normal(leaf.shape).astype(leaf.dtype)
        if names[-1] == "var" or "nu" in names:
            return (0.5 + np.abs(x)).astype(leaf.dtype)
        return (0.05 * x).astype(leaf.dtype)

    tree = jax.tree_util.tree_map_with_path(draw, abstract)
    return {**tree, "step": np.asarray(step, np.int32)}


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
def test_train_state_from_jax_is_exact(tmp_path, optimizer):
    jcfg = _jax_cfg(optimizer, grad_clip=1.0, freeze_bb=True)
    tree = _jax_state(jcfg)
    _save(tmp_path / "t", tree)
    got = train_state_from_jax(read_checkpoint(str(tmp_path / "t")), "cenet", optimizer)
    names = torch_names({"params": tree["params"]})
    slots = ("trace",) if optimizer == "sgd" else ("mu", "nu")
    # optax's chain: [multi_transform over {frozen, train}] → train: masked → [clip, [..moments.., ..]]
    chain = tree["opt_state"].inner_states["train"].inner_state[1]
    moments = next(s for s in chain if hasattr(s, slots[0]))
    want = {}
    for (_, path), key in names.items():
        if path[0] == "backbone":
            continue  # frozen: no slot
        want[key] = {}
        for s in slots:
            leaf = getattr(moments, s)
            for p in path:
                leaf = leaf[p]
            want[key][s] = _to_torch_layout(np.asarray(leaf), path)
    opt = got["optimizer"]
    assert opt["count"] == 6 and opt["state"].keys() == want.keys() and len(want) > 50
    for key, s in want.items():
        for slot, arr in s.items():
            assert opt["state"][key][slot].numpy().tobytes() == np.ascontiguousarray(arr).tobytes(), (key, slot)
    trainer = Trainer(_port_cfg(jcfg), 100, device="cpu")
    trainer.load_state_dict(got)
    assert trainer.step == 6 and all(p in dict(trainer.model.named_parameters()) for p in want)
    with pytest.raises(ValueError, match="optimizer is"):
        train_state_from_jax(read_checkpoint(str(tmp_path / "t")), "cenet", "adam" if optimizer == "sgd" else "sgd")
    read = read_checkpoint(str(tmp_path / "t"))
    read["step"] = np.int32(7)
    with pytest.raises(ValueError, match="step is 7"):
        train_state_from_jax(read, "cenet", optimizer)


def _batch(seed=1, b=2):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.standard_normal((b, 1, IMG, IMG)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 9, (b, IMG, IMG)).astype(np.int64))
    return images, labels


def test_resumed_step_equals_its_pth_twin(tmp_path):
    """A trainer restored from a JAX-written Orbax step, and one loaded from
    that state saved as the port's ``.pth``, take the same step to the bit."""
    jcfg = _jax_cfg()
    jckpt.CheckpointManager(str(tmp_path / "snap")).save(6, _jax_state(jcfg))
    cfg = _port_cfg(jcfg)
    a = CheckpointManager(str(tmp_path / "snap")).restore(Trainer(cfg, 100, device="cpu"))
    CheckpointManager(str(tmp_path / "pth")).save(a.step, a)
    b = CheckpointManager(str(tmp_path / "pth")).restore(Trainer(cfg, 100, device="cpu"))
    assert a.step == b.step == 6
    images, labels = _batch()
    for t in (a, b):
        t.train_step(images, labels)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["optimizer"]["count"] == sb["optimizer"]["count"] == 7
    for k, v in sa["state_dict"].items():
        assert torch.equal(v, sb["state_dict"][k]), k
    for n, slots in sa["optimizer"]["state"].items():
        assert torch.equal(slots["trace"], sb["optimizer"]["state"][n]["trace"]), n


class Volumes:
    def __init__(self, cases):
        self.cases = cases

    def volumes(self):
        return iter(self.cases)


def _volumes(rng, n=2):
    cases = []
    for i in range(n):
        label = np.zeros((3, 80, 80), np.uint8)
        label[:, 20:50, 24:60] = 1 + rng.integers(0, 8)
        label[:, 50:70, 10:30] = 1 + rng.integers(0, 8)
        image = (label * 0.1 + rng.integers(-40, 40, (3, 80, 80)) / 100.0).astype(np.float32)
        cases.append({"image": image, "label": label, "case_name": f"case000{i + 1}"})
    return Volumes(cases)


@contextlib.contextmanager
def _slim_cli():
    def preset(name, get=tconfig.get_preset):
        cfg = get(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, drop_path_rate=0.0),
                           data=dataclasses.replace(cfg.data, img_size=IMG))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "get_preset", preset)
        yield


def _cli(argv, test_set):
    out = io.StringIO()
    with _slim_cli(), contextlib.redirect_stdout(out):
        result = cli.main(argv, test_set=test_set)
    return result, out.getvalue()


def test_cli_eval_of_an_orbax_tag_equals_the_npz(tmp_path):
    tree = _jax_state(_jax_cfg())
    _save(tmp_path / "final", tree)
    jckpt._save_npz(str(tmp_path / "w.npz"), {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    test_set = _volumes(np.random.default_rng(0), n=1)
    argv = ["eval", "--preset", "synapse", "--encoder", ENCODER, "--device", "cpu", "--no-amp",
            "--output_dir", str(tmp_path / "out"), "--checkpoint"]
    got, stdout = _cli(argv + [str(tmp_path / "final")], test_set)
    want, _ = _cli(argv + [str(tmp_path / "w.npz")], test_set)
    assert got == want and json.loads(stdout.strip().splitlines()[-1]) == want
    assert snapshot_checkpoint(str(tmp_path)) == str(tmp_path / "final")  # the tag, found in its snapshot
    a = load_checkpoint(Trainer(_port_cfg(_jax_cfg()), 1, device="cpu").model, str(tmp_path))
    b = load_checkpoint(Trainer(_port_cfg(_jax_cfg()), 1, device="cpu").model, str(tmp_path / "w.npz"))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())


def test_cli_train_resumes_a_jax_snapshot(tmp_path):
    """The JAX package's step 4 (and a ``final`` tag) in the snapshot that
    ``cli train`` names: ``--resume`` takes the step, at ``it`` 4 and epoch
    4 // 2 (JAX's rule), and runs its last epoch's two steps; after it the
    port's ``.pth`` files win the latest step and the ``final`` tag."""
    rng = np.random.default_rng(0)
    names = []
    for i in range(4):
        label = np.zeros((IMG, IMG), np.uint8)
        label[10:30, 12:40] = 1 + i
        image = (label * 0.1 + rng.integers(-40, 40, (IMG, IMG)) / 100.0).astype(np.float32)
        names.append(f"case0001_slice{i:03d}")
        np.savez(tmp_path / f"{names[-1]}.npz", image=image, label=label)
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    argv = ["train", "--preset", "synapse", "--encoder", ENCODER, "--device", "cpu", "--no-amp",
            "--root_path", str(tmp_path), "--list_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
            "--max_epochs", "3", "--eval_interval", "100", "--batch_size", "2", "--resume"]
    with _slim_cli():
        snap = cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(argv)))
    tree = _jax_state(_jax_cfg(), step=4)
    jsnap = jckpt.CheckpointManager(snap)
    jsnap.save(4, tree)
    jsnap.save(4, tree, tag="final")
    mgr = CheckpointManager(snap)
    assert mgr.latest_step() == 4 and mgr.available_tags() == ["final"]
    assert snapshot_checkpoint(snap) == os.path.join(snap, "final")
    trainer, stdout = _cli(argv, _volumes(rng))
    assert "resumed from step 4 at iter 4 (epoch 2, momentum restored)" in stdout
    assert trainer.step == 6
    assert mgr.latest_step() == 6 and os.path.isfile(os.path.join(snap, "steps", "6.pth"))
    assert os.path.isdir(os.path.join(snap, "steps", "4", "default"))  # the JAX package's files stay
    assert snapshot_checkpoint(snap) == os.path.join(snap, "final.pth")  # the tag in both formats: the .pth
    restored = mgr.restore(Trainer(_port_cfg(_jax_cfg()), 6, device="cpu"), step=4)  # the Orbax step, named
    assert restored.step == 4
    want = load_train_state(os.path.join(snap, "steps", "4"), _port_cfg(_jax_cfg()))
    assert all(torch.equal(v, want["state_dict"][k]) for k, v in restored.model.state_dict().items())
