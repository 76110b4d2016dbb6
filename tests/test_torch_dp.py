"""Data parallelism of the port on the CPU: ``data=2`` over gloo against one process.

Two ranks (``tests/torch_mesh_ranks.py``, spawned once for the file) each
take their rows of a seeded global batch of 8 and run 2 SGD steps of
CENet-b0 at 64 px (``tests/test_trainer.py:118-158``'s configuration) with
drop-path 0.1 and the global-norm clip at 0.1, for ``loss_type`` boundary and
``dice,ce``, and once at a global batch of 2, where each rank holds one row
and the CCU must still see two. The parent runs the same steps in one
process meanwhile. JAX's DP gate limits hold: losses to rtol 2e-4, every
parameter and BatchNorm statistic to 5e-4 max-abs. Each update is small
beside its weights, so the gradient path is held apart: the parameter
updates and the SGD slots within 1e-3 of their whole norm and 1e-2 of each
tensor's (``torch_mesh_ranks.relative_errors``). The ranks end with one
state, equal to the bit, and a CE loss over unequal local batches raises on
both.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.data.loader import Loader
from cenet_tpu_torch.train.trainer import Trainer

CASES = {
    "boundary": dict(loss_type="boundary"),
    "dice_ce": dict(loss_type="dice,ce", loss_weights="0.5,0.5"),
    "global_batch_2": dict(batch=2),
}
LOSS_RTOL, PARAM_ATOL = 2e-4, 5e-4


@pytest.fixture(scope="module")
def runs():
    ranks = R.start_ranks("rank_train", 2, {"cases": [(kw, (2, 1)) for kw in CASES.values()], "unequal_ce": True})
    try:
        refs = {name: R.train(R.dp_config(**kw)) for name, kw in CASES.items()}
    finally:
        got = ranks.results()
    return refs, got


def _max_diff(a, b):
    return max((a[k].double() - b[k].double()).abs().max().item() for k in a)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_one_process(runs, case):
    refs, got = runs
    want_losses, want = refs[case]["losses"], refs[case]["state"]
    i = list(CASES).index(case)
    for rank in range(2):
        run = got[rank]["train"][i]
        losses, state = run["losses"], run["state"]
        assert run["plan"] == [] and run["impl"] == "pallas"  # no model axis: nothing sharded, no tag
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        assert set(state["state_dict"]) == set(want["state_dict"])
        assert _max_diff(state["state_dict"], want["state_dict"]) < PARAM_ATOL
        errs = R.relative_errors(state, want, refs[case]["init"])  # the gradient path: updates and slots
        assert max(errs["update"][0], errs["slot"][0]) < R.WHOLE_RTOL, errs
        assert max(errs["update"][1], errs["slot"][1]) < R.TENSOR_RTOL, errs
        slots = {n: s["trace"] for n, s in state["optimizer"]["state"].items()}
        assert _max_diff(slots, {n: s["trace"] for n, s in want["optimizer"]["state"].items()}) < PARAM_ATOL
        assert state["optimizer"]["count"] == want["optimizer"]["count"] == 2


def test_dp_ranks_end_with_one_state(runs):
    _, got = runs
    for s0, s1 in ((a["state"], b["state"]) for a, b in zip(got[0]["train"], got[1]["train"])):
        assert all(torch.equal(s0["state_dict"][k], s1["state_dict"][k]) for k in s0["state_dict"])
        for n, slots in s0["optimizer"]["state"].items():
            assert torch.equal(slots["trace"], s1["optimizer"]["state"][n]["trace"])


def test_ce_over_unequal_local_batches_raises(runs):
    _, got = runs
    for rank in range(2):
        assert "local batches differ" in got[rank]["unequal_ce"]


def test_the_gates_exercise_the_clip_and_drop_path():
    """The configuration's first gradient is above the clip (so the clip
    scales it), and its encoder holds drop-path layers at a rate above 0."""
    from cenet_tpu_torch.nn.layers import DropPath

    tr = Trainer(R.dp_config(), max_iterations=10, device="cpu")
    tr.model.train()
    _, grads = tr.loss_and_grads(*R.batch(8))
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads if g is not None]))
    assert norm > tr.cfg.train.grad_clip
    assert any(isinstance(m, DropPath) and m.rate > 0 for m in tr.model.modules())


@pytest.mark.parametrize("parts", [2, 4])
def test_loader_rank_rows_are_the_one_process_rows(parts):
    """With ``rows=(d, parts)`` a loader builds rows d·B/parts … of each batch,
    equal to those of the one-process loader (per-sample generators)."""
    def sample(i, rng):
        return {"image": np.full((2, 2), float(i), np.float32) + rng.standard_normal((2, 2)).astype(np.float32)}

    whole = list(Loader(12, sample, 4, seed=3, num_threads=1).epoch(1))
    for d in range(parts):
        mine = list(Loader(12, sample, 4, seed=3, num_threads=1, rows=(d, parts)).epoch(1))
        n = 4 // parts
        for a, b in zip(mine, whole):
            np.testing.assert_array_equal(a["image"], b["image"][d * n : (d + 1) * n])
