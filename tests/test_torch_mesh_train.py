"""Sharded training of the port on spawned CPU ranks (gloo): smoke hymba
in float32 on the (data, model) meshes (2, 1) and (1, 2), two steps of
``make_train_step(cfg, mesh)`` from one state against two of the port's
one-device step and of ``jax.jit(repro.train.step.make_train_step)`` on
the global batch (``tests/torch_train_cases.py``'s bands: loss, nll, aux
and grad_norm 1e-5, lr 1e-6, gradients 1e-4 of each leaf's largest
magnitude, moments and parameters by ``adamw_param_check``), a batch
whose halves hold different numbers of valid labels, microbatches split
over the batch ranks, and the signature guard of ``make_train_step``.
The MoE cases are in tests/test_torch_mesh_moe.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

from torch_train_cases import B, S, run_case

torch.set_num_threads(1)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)],
                         ids=["data2", "model2"])
def test_sharded_train_step_matches_jax_and_one_device(mesh_shape):
    run_case("hymba_1_5b", mesh_shape=mesh_shape)


def test_unequal_label_counts_over_batch_ranks():
    """Rank 0's rows hold 5 valid labels, rank 1's 30: a mean of the
    ranks' means would weigh them alike; the global mean does not."""
    cfg = tconfigs.get_smoke("hymba_1_5b")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    labels[0, 3:] = -1
    labels[1, 2:] = -1
    assert (labels[:2] >= 0).sum() == 5 and (labels[2:] >= 0).sum() == 30
    batch = ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
             {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)})
    run_case("hymba_1_5b", mesh_shape=(2, 1), batch=batch)


def test_sharded_microbatches_match_jax():
    """Two microbatches over two batch ranks: each rank runs its own rows
    as one microbatch, the reference's grouping of the global batch."""
    run_case("hymba_1_5b", mb=2, start_step=150, warmup=100,
             mesh_shape=(2, 1))


def test_make_train_step_takes_the_mesh_second():
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3_2_1b"))
    with pytest.raises(TypeError, match="opt_cfg="):
        tstep.make_train_step(cfg, toptim.AdamWConfig())
    assert callable(tstep.make_train_step(cfg, None, toptim.AdamWConfig()))
    assert callable(tstep.make_train_step(cfg, opt_cfg=toptim.AdamWConfig()))
