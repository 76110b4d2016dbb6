"""Helpers for the port's parity tests: JAX module → port module with the same weights.

JAX variables go through ``cenet_tpu_torch.convert.state_dict_from_jax`` into the
port module (strict load). Arrays cross between the frameworks as numpy; NHWC
(JAX) and NCHW (port) are converted here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cenet_tpu_torch.convert.jax2torch import _flatten, state_dict_from_jax, torch_key_for

# The port's tests run at small sizes, often beside the JAX suite in parallel
# pytest workers on shared cores. One intra-op thread keeps torch's OpenMP pool
# from spinning against the other workers: with the default of one thread per
# core and six workers on eight cores, a 3.7 s CENet-b0 train-step test took
# 94 s. Every worker imports this module when it collects the port's tests.
torch.set_num_threads(1)


# Cheap XLA compiles for test-only programs: the init values do not depend on them.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_init(module, *args, rng_seed=0, **kw):
    """Initialise a flax module (jitted) and return its variables as numpy."""
    key = jax.random.PRNGKey(rng_seed)
    init = jax.jit(lambda k, *a: module.init(k, *a, **kw)).lower(key, *args).compile(compiler_options=FAST_COMPILE)
    return jax.tree.map(np.asarray, dict(init(key, *args)))


def randomize_stats(variables, seed=1):
    """Give every BatchNorm non-trivial running statistics (fresh ones are 0 / 1)."""
    if "batch_stats" not in variables:
        return variables
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.5 + rng.random(x.shape)).astype(np.float32)

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return out


def load_port(port_module, variables, wrap="m", strip=None, model_version="cenet"):
    """Load JAX ``variables`` of one module into ``port_module`` (strict).

    Keys are derived with the module wrapped under ``wrap`` ("a/b" nests it; the
    parent names decide some torch names, e.g. ``up1`` for up blocks) and the
    torch prefix ``strip`` (default: ``wrap`` with dots) is then taken off.
    """
    wrapped = dict(variables)
    for name in reversed(wrap.split("/")):
        wrapped = {c: {name: tree} for c, tree in wrapped.items()}
    sd = state_dict_from_jax(wrapped, model_version)
    prefix = strip if strip is not None else wrap.replace("/", ".") + "."
    assert all(k.startswith(prefix) for k in sd), (prefix, list(sd)[:3])
    port_module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def variables_from_port(model, template, model_version="cenet"):
    """The port model's weights as JAX variables of ``template``'s tree (numpy
    leaves, e.g. from ``jax.eval_shape``): each leaf named with the port's
    ``torch_key_for`` and put back into the JAX layout. The inverse of
    ``state_dict_from_jax``; unlike the JAX package's ``convert_state_dict`` it
    takes the ResNet backbone's torchvision keys."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    siblings = {}
    for c in template:
        for path, _ in _flatten(template[c]):
            for j in range(len(path)):
                siblings.setdefault("/".join(path[:j]), set()).add(path[j])
    out = {}
    for c in template:
        tree = out.setdefault(c, {})
        for path, leaf in _flatten(template[c]):
            t = sd[torch_key_for(path, c, model_version, siblings)]
            if t.ndim == 4:
                t = t.transpose(2, 3, 0, 1) if path[-2] in ("up", "transp_conv") else t.transpose(2, 3, 1, 0)
            elif t.ndim == 2 and path[-1] == "weight":
                t = t.T
            d = tree
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = np.array(t.reshape(np.shape(leaf)), dtype=np.asarray(leaf).dtype, order="C")  # 0-d kept
    return out


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def nhwc(x_nchw):
    return x_nchw.detach().cpu().numpy().transpose(0, 2, 3, 1)


# --- the attention tests: inputs made with numpy, handed to both packages


def to_torch(a):
    return torch.from_numpy(np.array(a))


def rand32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def interleaved_qkv(rng, b, h, n, m, d, dv):
    """q/k as the diff-attention projections lay them out, (B, N, 2h, d) viewed as
    (B, 2h, N, d) with q pre-scaled, and v (B, h, M, dv)."""
    q = to_torch(rand32(rng, b, n, 2 * h, d) * d**-0.5).transpose(1, 2)
    k = to_torch(rand32(rng, b, m, 2 * h, d)).transpose(1, 2)
    return q, k, to_torch(rand32(rng, b, h, m, dv))


def head_groups(q, k):
    """The split groups of interleaved q/k: (q1, k1, q2, k2), head views."""
    return q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2]


def to_jax(*tensors):
    """fp32 JAX copies (numpy has no bf16; callers cast back)."""
    return [jnp.asarray(t.detach().float().numpy()) for t in tensors]


def jit_bound(fn, **static):
    """``fn`` with ``static`` bound, jitted whole: one XLA compile instead of one
    dispatch per operation (the Pallas interpreter makes many)."""
    return jax.jit(functools.partial(fn, **static))


def assert_all_close(got, want, atol, names):
    """Each pair within ``atol`` absolute and relative, compared in fp32."""
    for name, a, w in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(w, np.float32), atol=atol, rtol=atol,
                                   err_msg=name)
