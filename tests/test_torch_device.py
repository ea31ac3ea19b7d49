"""The port's device rules on the CPU: full float32 on the card (TF32 off for
cuDNN and for matrix products) and the deterministic mode, set by every
entry point that takes it."""
import os

import pytest
import torch
import torch.utils.deterministic

from depthinspace_tpu_torch.device import (resolve_device, set_deterministic,
                                           set_full_f32)


@pytest.fixture
def tf32_on(monkeypatch):
    """TF32 on and the deterministic mode off, as torch starts; every flag
    (and CUBLAS_WORKSPACE_CONFIG) as it was afterwards, so that the mode
    does not leak into the worker's other tests."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved[:4]
    torch.use_deterministic_algorithms(saved[4])
    torch.utils.deterministic.fill_uninitialized_memory = saved[5]


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


def test_resolve_device_sets_the_deterministic_mode_for_the_card_only(
        tf32_on):
    """A CUDA device turns cuDNN's deterministic algorithms and torch's
    deterministic mode on, without NaN-filled allocations, and sets cuBLAS's
    deterministic workspace; the CPU leaves all of it alone."""
    resolve_device("cpu")
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    resolve_device("cuda:0")
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.utils.deterministic.fill_uninitialized_memory is False
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


@pytest.mark.parametrize("given,kept", [(":16:8", ":16:8"),
                                        (":4096:8", ":4096:8"),
                                        (":0:0", ":4096:8")])
def test_set_deterministic_keeps_a_deterministic_cublas_setting(
        tf32_on, monkeypatch, given, kept):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", given)
    set_deterministic()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == kept
