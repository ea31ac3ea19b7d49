"""The port's device rules on the CPU: full float32 on the card (TF32 off for
cuDNN and for matrix products), set by every entry point that takes it."""
import pytest
import torch

from depthinspace_tpu_torch.device import resolve_device, set_full_f32


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_set_full_f32_turns_tf32_off(tf32_on):
    set_full_f32()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_resolve_device_sets_full_f32_for_the_card_only(tf32_on):
    """A CUDA device (named; no card is needed to name one) turns TF32 off;
    the CPU leaves the flags alone."""
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is True
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
