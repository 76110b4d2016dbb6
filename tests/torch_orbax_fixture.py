"""Write ``tests/torch_orbax_data/``: a full-width CENet-b2 TrainState (Synapse
preset) saved by the JAX package's own ``CheckpointManager``, for the port's
Orbax bridge to read without JAX (``cenet_tpu_torch/core/orbax.py``).

    python tests/torch_orbax_fixture.py [--out tests/torch_orbax_data]

Needs JAX, Flax, optax and ``orbax.checkpoint`` (the JAX package's
environment), and no accelerator: the TrainState's tree comes from
``jax.eval_shape`` of ``Trainer.init_state`` (no compile), and every leaf is
then filled with a pattern that repeats every 61 elements, so that the files
stay small while no leaf is constant and the model's predictions vary with
the input:

* leaf ``j`` (in the order of ``jax.tree_util.tree_flatten_with_path``) of
  ``n`` elements takes ``u[i] = frac(0.6180339887 (i mod 61) + 0.137 j)``
  for ``i < n`` in C order, in [0, 1);
* a parameter takes its own initial scale: with ``m`` and ``s`` the mean and
  standard deviation of the same tensor in the port's seeded CENet-b2 (whose
  initialisers are the JAX package's), ``m + 2√3 s (u − 0.5)`` where ``s > 0``
  (a uniform draw of that mean and deviation), ``m (1 + 0.2 (u − 0.5))`` where
  the tensor is a constant ``m ≠ 0`` (norm scales, layer scales), and
  ``0.02 (u − 0.5)`` where it is zero (biases); a pattern of one scale for
  every leaf makes the decoder's gated blocks blow up, or the output a
  constant class, whose HD95 is undefined;
* the SGD momentum (``trace``) ``0.001 u``, BatchNorm means
  ``0.1 (u − 0.5)`` and variances ``0.5 + u`` (positive);
* integer leaves (the schedule's count) and the TrainState's ``step`` are
  :data:`STEP`.

It writes the step ``STEP`` (``<out>/steps/37/default``, about 1.5 MB) and
``<out>/manifest.json``: the step, the pattern, and each leaf's path
(``/``-joined, list indices as numbers), shape, dtype and the sha256 of its
C-order little-endian bytes. No tag: a ``final`` tag beside it would take the
directory past 2 MB, and the port's tests write their own tags.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 37
PERIOD = 61
PATTERN = ("leaf j of n elements: u[i] = frac(0.6180339887 (i mod 61) + 0.137 j); params m + 2sqrt(3)s(u - 0.5) "
           "with m, s the mean and deviation of the port's seeded initial tensor (m(1 + 0.2(u - 0.5)) where s = 0, "
           "m != 0; 0.02(u - 0.5) where zero); trace 0.001u; BatchNorm mean 0.1(u - 0.5), var 0.5 + u; integer "
           "leaves and step = 37")


def key_name(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def pattern(j: int, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.int64) % PERIOD
    return np.modf(0.6180339887 * i + 0.137 * j)[0].astype(np.float32)


def fill(path, leaf, j, init):
    """Leaf ``j`` filled as the module's docstring says; ``init`` maps a
    parameter's path to the (mean, deviation) of its initial tensor."""
    names = [key_name(k) for k in path]
    if np.issubdtype(leaf.dtype, np.integer):
        return np.full(leaf.shape, STEP, leaf.dtype)
    u = pattern(j, int(np.prod(leaf.shape, dtype=np.int64))).reshape(leaf.shape)
    if names[0] == "batch_stats":
        return (0.1 * (u - 0.5) if names[-1] == "mean" else 0.5 + u).astype(leaf.dtype)
    if names[0] == "opt_state":
        return (0.001 * u).astype(leaf.dtype)
    m, s = init[tuple(names[1:])]
    if s > 0:
        return (m + 2 * np.sqrt(3.0) * s * (u - 0.5)).astype(leaf.dtype)
    if m != 0:
        return (m * (1 + 0.2 * (u - 0.5))).astype(leaf.dtype)
    return (0.02 * (u - 0.5)).astype(leaf.dtype)


def initial_scales(params_tree) -> dict:
    """(mean, deviation) of each parameter of the port's seeded CENet-b2 of the
    Synapse preset, by its JAX path (named with the port's converter)."""
    from cenet_tpu_torch.convert.jax2torch import torch_names
    from cenet_tpu_torch.core.config import get_preset as port_preset
    from cenet_tpu_torch.models.cenet import build_model

    sd = build_model(port_preset("synapse"), device="cpu", seed=0).state_dict()
    out = {}
    for (_, path), key in torch_names({"params": params_tree}).items():
        t = sd[key].double()
        out[path] = (float(t.mean()), float(t.std()) if t.numel() > 1 else 0.0)
    return out


def leaf_record(path, arr) -> dict:
    a = np.array(arr, order="C")  # not ascontiguousarray, which makes a 0-d leaf (1,)
    return {"path": "/".join(key_name(k) for k in path), "shape": list(a.shape), "dtype": a.dtype.name,
            "sha256": hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()).hexdigest()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "tests", "torch_orbax_data"))
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cenet_tpu.core.checkpoint import CheckpointManager, _state_to_tree
    from cenet_tpu.core.config import get_preset
    from cenet_tpu.train.trainer import Trainer

    cfg = get_preset("synapse")
    trainer = Trainer(cfg, max_iterations=1000)
    shape = (1, cfg.data.img_size, cfg.data.img_size, cfg.model.input_channels)
    abstract = jax.eval_shape(lambda key: trainer.init_state(key, shape), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(_state_to_tree(abstract))
    init = initial_scales(jax.tree.map(lambda a: np.zeros((), a.dtype), abstract.params))
    filled = [fill(path, leaf, j, init) for j, (path, leaf) in enumerate(leaves)]
    tree = jax.tree_util.tree_unflatten(treedef, filled)
    tree["step"] = np.asarray(STEP, np.int32)
    if os.path.exists(args.out):
        shutil.rmtree(args.out)
    ckpt = CheckpointManager(args.out, keep=1)
    ckpt.save(STEP, tree)
    records = [leaf_record(path, leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    manifest = {"preset": "synapse", "encoder": cfg.model.encoder, "optimizer": cfg.train.optimizer, "step": STEP,
                "steps": [STEP], "pattern": PATTERN, "leaves": records}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(args.out) for n in ns)
    print(json.dumps({"out": args.out, "leaves": len(records), "elements": int(sum(np.prod(r["shape"]) for r in records)),
                      "bytes_on_disk": total}))


if __name__ == "__main__":
    main()
