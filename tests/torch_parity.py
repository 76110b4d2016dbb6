"""Helpers for the port's parity tests: JAX module → port module with the same weights.

JAX variables go through ``cenet_tpu_torch.convert.state_dict_from_jax`` into the
port module (strict load). Arrays cross between the frameworks as numpy; NHWC
(JAX) and NCHW (port) are converted here.
"""

import jax
import numpy as np
import torch

from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax

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


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def nhwc(x_nchw):
    return x_nchw.detach().cpu().numpy().transpose(0, 2, 3, 1)
