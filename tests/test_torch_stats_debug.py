"""``core/stats.py`` (``model_cost``, ``print_model_stats``), ``core/debug.py``
and ``core/logging_utils.py::ProfilerHook``, on the CPU.

``model_cost`` counts the forward's plain route on the ``meta`` device, so a
conv, a linear and an attention site read their analytic FLOPs exactly, and a
CENet reads the same count whatever its ``attn_impl``. The JAX package's count
is XLA's and also counts elementwise operators; the slow gate in
``tests/test_torch_slow_jax_gates.py`` holds the ratio of the two.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
import torch.nn as nn

import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.core import debug
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.core.logging_utils import ProfilerHook
from cenet_tpu_torch.core.stats import model_cost, print_model_stats
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.nn.attention import MultiheadDiffAttn, SRAAttention
from cenet_tpu_torch.nn.layers import Conv2d, Linear


class _Tokens(nn.Module):
    """An attention module called on (B, N, C) tokens of an H × W map."""

    def __init__(self, attn, hw=None):
        super().__init__()
        self.attn, self.hw = attn, hw

    def forward(self, x):
        return self.attn(x, *self.hw) if self.hw else self.attn(x)


@pytest.mark.parametrize("module, shape, flops", [
    # 2 · Cout · Cin · k² · output pixels (the bias is not counted)
    pytest.param(Conv2d(3, 8, 3, padding=1), (2, 3, 16, 12), 2 * 8 * 3 * 9 * 2 * 16 * 12, id="conv"),
    pytest.param(Conv2d(4, 6, 5, stride=2, padding=2), (1, 4, 20, 20), 2 * 6 * 4 * 25 * 10 * 10, id="strided-conv"),
    pytest.param(Linear(16, 32), (2, 10, 16), 2 * 2 * 10 * 16 * 32, id="linear"),
    # q, kv, proj linears 2·B·N·(C² + 2C² + C²); logits and the product with v 2·B·N·M·(C + C)
    pytest.param(_Tokens(SRAAttention(16, num_heads=2, qkv_bias=True, attn_impl="pallas"), (4, 5)), (2, 20, 16),
                 2 * 2 * 20 * 4 * 16 * 16 + 2 * 2 * 20 * 20 * 32, id="sra-attention"),
    # four E × E projections 2·B·N·4E²; logits 2·B·2h·N²·hd, two products with v 2·2·B·h·N²·2hd
    *[pytest.param(_Tokens(MultiheadDiffAttn(16, depth=1, num_heads=2, attn_impl=impl)), (2, 12, 16),
                   2 * 2 * 12 * 4 * 16 * 16 + 2 * 2 * 12 * 12 * 16 + 2 * 2 * 2 * 12 * 12 * 16,
                   id=f"diff-attention-{impl}")
      for impl in ("pallas", "xla", "chunked")],
])
def test_model_cost_counts_the_analytic_flops(module, shape, flops):
    cost = model_cost(module, shape)
    assert cost["flops_g"] * 1e9 == pytest.approx(flops, rel=1e-12)
    assert cost["params_m"] * 1e6 == sum(p.numel() for p in module.parameters())
    assert cost["bytes_accessed_gb"] > 0


def _b0(impl):
    base = get_preset("synapse")
    return build_model(base.replace(model=dataclasses.replace(base.model, encoder="pvt_v2_b0", attn_impl=impl)),
                       device="cpu", seed=0)


def test_model_cost_is_the_same_for_every_attn_impl_and_leaves_the_model_alone():
    """CENet-b0 at 64 px: the same FLOPs with ``attn_impl`` 'pallas', 'xla'
    and 'chunked' (the 'xla' path merges the DSEB groups' weights before one
    product with V and is counted as the plain route's two); the model keeps
    its device, its mode and its weights."""
    counts = {}
    for impl in ("pallas", "xla", "chunked"):
        model = _b0(impl).train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        counts[impl] = model_cost(model, (1, 1, 64, 64))
        assert model.training and next(model.parameters()).device.type == "cpu"
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    flops = {impl: c["flops_g"] for impl, c in counts.items()}
    assert len(set(flops.values())) == 1, flops
    assert 0.30 < flops["pallas"] < 0.33  # 0.3142 GFLOPs


def test_model_cost_does_not_depend_on_what_ran_before():
    """The resampling matrices are copied to a device once and cached; the
    count reads the same with the cache cold and warm."""
    from cenet_tpu_torch.nn import functional as F

    model = _b0("pallas")
    F._matrix_on.cache_clear()
    cold = model_cost(model, (1, 1, 64, 64))
    assert model_cost(model, (1, 1, 64, 64)) == cold


def test_print_model_stats_logs_the_jax_line():
    lines = []
    stats = print_model_stats(_b0("pallas"), (1, 1, 64, 64), log=lines.append)
    assert len(lines) == 1
    m = re.fullmatch(r"model: (\d+\.\d\d) M params, (\d+\.\d\d) GFLOPs @ \(1, 1, 64, 64\), (\d+\.\d\d) GB accessed",
                     lines[0])
    assert m, lines[0]
    assert [float(g) for g in m.groups()] == [round(stats[k], 2) for k in ("params_m", "flops_g", "bytes_accessed_gb")]


def test_model_cost_raises_where_meta_cannot_run():
    class ReadsAValue(nn.Module):
        def forward(self, x):
            return x * float(x.sum())

    with pytest.raises(Exception, match="meta"):
        model_cost(ReadsAValue(), (1, 3))


def test_profiler_hook_writes_one_trace_of_its_window(tmp_path):
    """Steps 0..7 with start 3 and 2 steps: a trace written at step 5, holding
    steps 3 and 4 and no other; repeated calls start and stop nothing."""
    hook = ProfilerHook(str(tmp_path), start_step=3, num_steps=2)
    x = torch.randn(32, 32)
    for step in range(8):
        for _ in range(2):  # a second call at the same step changes nothing
            hook.maybe_start_stop(step)
        assert os.listdir(tmp_path) == ([] if step < 5 else ["trace_steps_3-5.json"]), step
        with torch.profiler.record_function(f"step_{step}"):
            x @ x
    with open(hook.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step_3", "step_4"} <= names
    assert not names & {f"step_{s}" for s in (0, 1, 2, 5, 6, 7)}


def test_nan_check_mode_raises_on_a_nan_backward_and_restores_the_mode():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    assert not torch.is_anomaly_enabled()
    with debug.nan_check_mode():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        y = torch.sqrt(x).nan_to_num()
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).nan_to_num().sum().backward()  # outside the mode: no check
    with pytest.raises(ZeroDivisionError), debug.nan_check_mode():
        1 / 0
    assert not torch.is_anomaly_enabled()


def test_assert_finite_names_the_bad_keys():
    sd = _b0("pallas").state_dict()
    debug.assert_finite(sd, "state")
    debug.assert_finite({"a": [torch.ones(2), (torch.zeros(1, dtype=torch.int64),)]})
    sd["decoder.dec1.norm1.weight"][0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"non-finite values in state: \['decoder.dec1.norm1.weight'\]"):
        debug.assert_finite(sd, "state")
    tree = {"opt": [{f"m{i}": torch.tensor([float("inf")]) for i in range(12)}], "ok": torch.ones(3)}
    with pytest.raises(FloatingPointError) as err:
        debug.assert_finite(tree)
    assert "opt/0/m0" in str(err.value) and "opt/0/m9" in str(err.value) and "m10" not in str(err.value)


def test_tree_norm_matches_numpy():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    tree = {"a": torch.from_numpy(arrays[0]), "b": [torch.from_numpy(arrays[1]),
                                                    (torch.from_numpy(arrays[2]).to(torch.bfloat16),)]}
    want = np.linalg.norm(np.concatenate([arrays[0].ravel(), arrays[1].ravel(),
                                          tree["b"][1][0].float().numpy().ravel()]))
    assert isinstance(debug.tree_norm(tree), float)
    assert debug.tree_norm(tree) == pytest.approx(float(want), rel=1e-6)
