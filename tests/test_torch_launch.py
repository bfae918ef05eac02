"""The port's training launcher (``python -m repro_torch.launch.train``,
``repro_torch.launch.train.main``) on the CPU at smoke size, with the
reference launcher's flags and behaviour: the loss falls over 20 steps,
a checkpoint and ``--resume`` give the straight run's state, SIGTERM
checkpoints and returns 0, the watchdog returns 42, ``--mtbf`` sets the
Young/Daly cadence, two spawned ranks (gloo) run the sharded step to the
one-rank state; ``make_local_mesh`` clamps as the reference's does."""
import json
import os
import signal

import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core import shard_sim
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train

import torch_spmd

torch.set_num_threads(1)
ARGS = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--lr", "1e-2", "--log-every", "5"]


def _files(d, step):
    """{path: array} of a checkpoint."""
    root = d / f"step_{step:010d}"
    man = json.loads((root / "manifest.json").read_text())
    return {m["path"]: np.load(root / f"{m['name']}.npy")
            for m in man["leaves"]}


def test_loss_falls_over_20_steps(capsys):
    assert train.main(ARGS + ["--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert "(DECREASED)" in out, out


def test_checkpoint_and_resume_equal_straight(tmp_path, monkeypatch,
                                              capsys):
    """A: 6 steps, saving async at 3 and blocking at 6.  B: stopped by
    SIGTERM during step 2 (saves step 3), then ``--resume``: its step 6
    equals A's bit for bit on the CPU."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert train.main(ARGS + ["--steps", "6", "--ckpt-dir", str(a),
                              "--ckpt-every", "3"]) == 0
    assert sorted(Checkpointer(a).all_steps()) == [3, 6]

    real = train.get_batch

    def preempt(dc, step, **kw):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(dc, step, **kw)
    monkeypatch.setattr(train, "get_batch", preempt)
    assert train.main(ARGS + ["--steps", "6", "--ckpt-dir", str(b),
                              "--ckpt-every", "50"]) == 0
    assert "SIGTERM at step 2" in capsys.readouterr().out
    assert Checkpointer(b).all_steps() == [3]
    monkeypatch.setattr(train, "get_batch", real)
    assert train.main(ARGS + ["--steps", "6", "--ckpt-dir", str(b),
                              "--resume"]) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    fa, fb = _files(a, 6), _files(b, 6)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k
    # the signal handlers are the caller's again
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_watchdog_returns_42_with_a_checkpoint(tmp_path, capsys):
    assert train.main(ARGS + ["--steps", "5", "--ckpt-dir", str(tmp_path),
                              "--step-timeout-s", "1e-9"]) == 42
    assert "WATCHDOG: step 0" in capsys.readouterr().out
    assert Checkpointer(tmp_path).all_steps() == [1]


def test_mtbf_sets_the_cadence(tmp_path, capsys):
    """sqrt(2 * 1 * 8) = 4 steps between checkpoints, then the final one."""
    assert train.main(ARGS + ["--steps", "9", "--ckpt-dir", str(tmp_path),
                              "--mtbf", "8", "--ckpt-cost", "1",
                              "--ckpt-every", "2"]) == 0
    assert "checkpoint every ~4s" in capsys.readouterr().out
    assert sorted(Checkpointer(tmp_path).all_steps()) == [4, 8, 9]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_local_mesh_clamps_as_the_reference(n, monkeypatch):
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: shape)
    for data in (1, 2, 4, 16):
        for model in (1, 2, 3, 8):
            assert tmesh.local_shape(data, model, n) \
                == tuple(jmesh.make_local_mesh(data, model)), (n, data,
                                                               model)
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_local_mesh(1, 1, device="cpu")


def test_two_ranks_run_to_the_one_rank_state(tmp_path):
    """``--data 2`` over two spawned ranks: the mesh is (2, 1), rank 0
    writes, and the final state is the one-rank run's within bf16
    roundings (the smoke config is bf16)."""
    one, two = tmp_path / "one", tmp_path / "two"
    assert train.main(ARGS + ["--steps", "4", "--ckpt-dir", str(one)]) == 0
    res = shard_sim.spawn(torch_spmd.launch_main, 2, (
        ARGS + ["--steps", "4", "--ckpt-dir", str(two), "--data", "2"],))
    assert res == [0, 0]
    f1, f2 = _files(one, 4), _files(two, 4)
    assert list(f1) == list(f2)
    for k in f1:
        a, b = f1[k], f2[k]
        if a.dtype == np.uint16:                       # bf16 bits
            a = (a.astype(np.uint32) << 16).view(np.float32)
            b = (b.astype(np.uint32) << 16).view(np.float32)
        err = float(np.linalg.norm(a.astype(np.float64) - b))
        assert err <= 5e-2 * float(np.linalg.norm(a.astype(np.float64))) \
            + 1e-6, (k, err)
