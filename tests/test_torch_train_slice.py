"""The training slice end to end, first half of the architectures of
tests/test_archs.py: the port's ``make_train_step`` against
``jax.jit(repro.train.step.make_train_step)`` on the smoke configurations
in float32, two steps from one state (``convert.train_state_from_jax``),
with one microbatch and with two (these start at step 150 of a 100-step
warmup, so the learning rate takes its cosine branch), plus the chunked
cross-entropy (``xent_chunk=2``); test_torch_train_slice2.py has the
bfloat16 case.  The comparison and
its tolerances are ``tests/torch_train_cases.py``'s; the other half of
the architectures is in test_torch_train_slice2.py."""
import pytest
import torch

from torch_train_cases import run_case

torch.set_num_threads(1)
ARCHS = ["hymba_1_5b", "gemma2_9b", "llama3_2_1b", "xlstm_350m",
         "qwen3_moe_235b_a22b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    run_case(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_microbatched_matches_jax(arch):
    run_case(arch, mb=2, start_step=150, warmup=100)


def test_train_step_chunked_xent_matches_jax():
    """gemma2: tied embeddings and the final softcap in the chunked loss."""
    run_case("gemma2_9b", xent_chunk=2)
