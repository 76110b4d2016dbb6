"""``cli train|eval --mesh`` on the CPU over gloo, against the runs without a mesh.

The slim ACDC preset (CENet-b0, its image size cut to 32 px, batch 2, two
epochs of two steps over four seeded 48 × 40 slices, the val → test →
``best`` cascade) trains:

* ``train --mesh 2`` as two hosts over ``--coordinator 127.0.0.1:<port>``
  (host 0 here, host 1 a subprocess on the same slim preset,
  ``torch_mesh_ranks.start_cli``), as ``tests/test_multihost.py`` runs the
  JAX package's, and ``train`` without a mesh: their ``final`` states agree
  to JAX's DP limits (5e-4 max-abs, momentum too), and rank 0 alone logs;
* a resume across meshes: the meshed snapshot cut back to its epoch-1 step
  and resumed without a mesh, and the one-process snapshot cut back and
  resumed under ``--mesh 2`` (the same host-1 process again), each ending
  where the uninterrupted run of the other kind ended (5e-4).

``eval --mesh 2`` of the meshed ``final``, launched alone (this process is
rank 0, and the CLI starts rank 1 with its argv and environment; the test
swaps only the command, ``python -m cenet_tpu_torch.cli.main``, for
``torch_mesh_ranks.cli_command``'s, which runs the same argv on the slim
preset), and ``eval`` without a mesh agree to 1e-6.

Every rendezvous and collective of these runs fails after 90 s
(``core.mesh.DEFAULT_TIMEOUT_S``, set here and in every rank this test
starts), and every wait on a subprocess has a timeout.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import torch_mesh_ranks as R
import torch_parity  # noqa: F401  (one intra-op thread for torch)
from cenet_tpu_torch.cli import main as cli
from cenet_tpu_torch.core import config as tconfig
from cenet_tpu_torch.core import mesh as M
from cenet_tpu_torch.tools.synthetic import write_acdc

PARAM_ATOL, JSON_ATOL, WAIT_S, IMG = 5e-4, 1e-6, 240, 32


def _argv(mode, root, out, *extra):
    return [mode, "--preset", "acdc", "--encoder", "pvt_v2_b0", "--device", "cpu", "--no-amp", "--root_path",
            str(root), "--list_dir", str(root), "--output_dir", str(out), "--batch_size", "2", "--max_epochs", "2",
            *extra]


def _join(proc):
    try:
        out, _ = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    return out


def _in_process(argv):
    """``cli.main(argv)`` here, with what it prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    return result, buf.getvalue().strip().splitlines()


def _snapshot_name():
    """The snapshot directory's name of these runs (the same for every output dir)."""
    return os.path.basename(cli.snapshot_path(cli.make_config(cli.build_argparser().parse_args(
        _argv("train", "data", "out")))))


def _snap(out):
    (name,) = os.listdir(out)
    return os.path.join(out, name)


def _cut_to_epoch_1(src, dst):
    """A copy of snapshot ``src`` as an interrupted run left it after epoch 1."""
    shutil.copytree(src, dst)
    steps = sorted(int(f[:-4]) for f in os.listdir(os.path.join(dst, "steps")))
    os.remove(os.path.join(dst, "steps", f"{steps[-1]}.pth"))
    os.remove(os.path.join(dst, "final.pth"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    data = root / "data"
    write_acdc(str(data), n_train=4, n_valid=1, n_test=1, depth=2, h=48, w=40)
    hosts = [["--mesh", "2", "--coordinator", f"127.0.0.1:{M.free_port()}", "--num_processes", "2"]
             for _ in range(2)]
    # host 1 of both two-host runs, started now so that its imports overlap the run without a mesh; it
    # waits at each rendezvous (before it reads any file) until host 0 (rank 0, here) joins it
    host1 = R.start_cli([_argv("train", data, root / "mesh", *hosts[0], "--process_id", "1"),
                         _argv("train", data, root / "one_cut", "--resume", *hosts[1], "--process_id", "1")], IMG)
    popen, started = subprocess.Popen, []

    def start_rank(cmd, **kw):  # the CLI's command for its other ranks, run on the slim preset
        if list(cmd[:3]) != [sys.executable, "-m", "cenet_tpu_torch.cli.main"]:
            return popen(cmd, **kw)
        started.append(kw["env"]["RANK"])
        return popen(R.cli_command([cmd[3:]], IMG), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the rank that the launched-alone eval starts
        mp.setattr(M, "DEFAULT_TIMEOUT_S", R.COLLECTIVE_TIMEOUT_S)
        mp.setattr(tconfig, "get_preset", R.slim_preset(tconfig.get_preset, IMG))
        mesh_snap = os.path.join(root / "mesh", _snapshot_name())
        done = False
        try:
            _in_process(_argv("train", data, root / "one"))
            _in_process(_argv("train", data, root / "mesh", *hosts[0], "--process_id", "0"))
            one_snap = _snap(root / "one")
            _cut_to_epoch_1(mesh_snap, root / "mesh_cut" / os.path.basename(mesh_snap))
            _cut_to_epoch_1(one_snap, root / "one_cut" / os.path.basename(one_snap))
            _in_process(_argv("train", data, root / "one_cut", "--resume", *hosts[1], "--process_id", "0"))
            done = True
        finally:
            if not done:  # host 1 would wait for a rendezvous that never comes
                host1.kill()
            host1_out = _join(host1)
        _in_process(_argv("train", data, root / "mesh_cut", "--resume"))
        ckpt = ["--checkpoint", os.path.join(mesh_snap, "final.pth")]
        with pytest.MonkeyPatch.context() as spawn:
            spawn.setattr(subprocess, "Popen", start_rank)
            eval_mesh, printed = _in_process(_argv("eval", data, root / "eval_mesh", *ckpt, "--mesh", "2"))
        assert started == ["1"]
        eval_one, _ = _in_process(_argv("eval", data, root / "eval_one", *ckpt))
    final = {name: torch.load(os.path.join(_snap(root / name), "final.pth"), weights_only=True)
             for name in ("mesh", "one", "mesh_cut", "one_cut")}
    return {"final": final, "eval_mesh": eval_mesh, "eval_one": eval_one, "printed": printed,
            "host1_out": host1_out, "mesh_snap": mesh_snap, "one_snap": one_snap}


def _max_diff(a, b):
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    diffs = [(a["state_dict"][k].double() - b["state_dict"][k].double()).abs().max().item() for k in a["state_dict"]]
    diffs += [(s["trace"].double() - b["optimizer"]["state"][n]["trace"].double()).abs().max().item()
              for n, s in a["optimizer"]["state"].items()]
    return max(diffs)


def test_mesh_train_matches_the_run_without_a_mesh(runs):
    f = runs["final"]
    assert set(f["mesh"]["state_dict"]) == set(f["one"]["state_dict"])
    assert _max_diff(f["mesh"], f["one"]) < PARAM_ATOL
    assert sorted(os.listdir(runs["mesh_snap"])) == sorted(os.listdir(runs["one_snap"]))
    with open(os.path.join(runs["mesh_snap"], "log_train.txt")) as fh:
        log = fh.read()
    assert log.count("mesh: data=2 model=1") == 1 and log.count("training done") == 1  # rank 0 alone logs
    assert "training done" not in runs["host1_out"]  # host 1 (rank 1) logs nothing


def test_mesh_eval_json_matches_the_run_without_a_mesh(runs):
    got, want = runs["eval_mesh"], runs["eval_one"]
    assert set(got) == set(want) == {"mean_dice", "mean_hd95"}
    assert all(abs(got[k] - want[k]) <= JSON_ATOL for k in want)
    assert json.loads(runs["printed"][-1]) == got  # rank 0 (this process) prints it


@pytest.mark.parametrize("resumed, uninterrupted", [("mesh_cut", "mesh"), ("one_cut", "one")],
                         ids=["mesh_checkpoint_resumed_without_a_mesh", "checkpoint_resumed_under_mesh_2"])
def test_resume_across_meshes(runs, resumed, uninterrupted):
    assert _max_diff(runs["final"][resumed], runs["final"][uninterrupted]) < PARAM_ATOL


def test_nccl_needs_a_card_per_rank():
    argv = ["train", "--preset", "acdc", "--mesh", "2"]
    with pytest.raises(SystemExit, match="one rank per card"):
        cli.main(argv)
