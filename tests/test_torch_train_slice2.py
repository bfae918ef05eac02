"""The training slice end to end, second half of the architectures of
tests/test_archs.py (see test_torch_train_slice.py): the port's
``make_train_step`` against the reference's, float32, two steps from one
state, one microbatch and two, plus whisper (frames into the encoder)
with the chunked cross-entropy, and hymba in bfloat16 (5e-2)."""
import pytest
import torch

from torch_train_cases import run_case

torch.set_num_threads(1)
ARCHS = ["moonshot_v1_16b_a3b", "qwen1_5_4b", "smollm_360m",
         "chameleon_34b", "whisper_large_v3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    run_case(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_microbatched_matches_jax(arch):
    run_case(arch, mb=2, start_step=150, warmup=100)


def test_train_step_chunked_xent_encoder_decoder_matches_jax():
    run_case("whisper_large_v3", xent_chunk=2)


def test_train_step_bf16_matches_jax():
    run_case("hymba_1_5b", dtype="bfloat16")
