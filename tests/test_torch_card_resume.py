"""On the card: a resumed run equals the uninterrupted one bit for bit, the
card twin of tests/test_torch_worker.py::test_resume_equals_uninterrupted_run,
for the DIS-SF train step in float32 and the DIS-MF train step in bfloat16,
both augmented on the device. It holds because every entry point that takes
the card turns the deterministic mode on (``device.set_deterministic``) and
the backward kernels sum as integers (``csrc/warp2d.cu``,
``csrc/warp2d_pairs.cu``). Every
test here needs an NVIDIA card and skips without one; this file imports no
JAX:

    python -m pytest tests/test_torch_card_resume.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from depthinspace_tpu_torch.data import (batch_to_torch, make_settings,
                                         make_track_batch)
from depthinspace_tpu_torch.models import (DispNet, FuseNet, init_dispnet_,
                                           init_fusenet_)
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_mf_train_step,
                                          make_sf_train_step)
from depthinspace_tpu_torch.train.checkpoint import StateCheckpointer
from depthinspace_tpu_torch.utils import jrandom

pytestmark = pytest.mark.cuda

H, W, TL = 128, 112, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(kind, settings):
    """(model factory, step factory, batch) of the SF f32 or MF bf16 step."""
    if kind == "sf_f32":
        batch = make_track_batch(settings, tl=TL, bs=2, seed=0,
                                 disp_range=(2.0, 12.0))
        return (lambda: init_dispnet_(DispNet(), jrandom.key(0)),
                make_sf_train_step, batch)
    batch = make_track_batch(settings, tl=TL, bs=2, seed=1,
                             disp_range=(2.0, 12.0), primary_noise=0.5)
    return (lambda: init_fusenet_(
                FuseNet((H, W), settings.K, TL, block_num=2, channels=16,
                        compute_dtype=torch.bfloat16), jrandom.key(1)),
            make_mf_train_step, batch)


@pytest.mark.parametrize("kind", ["sf_f32", "mf_bf16"])
def test_card_resume_equals_uninterrupted_run(cuda, tmp_path, kind):
    """3 steps in one run; 2 steps, save, restore into a fresh state, 1
    step: the same components, weights and step key, bit for bit; and a
    second uninterrupted run gives the first one's bits."""
    settings = make_settings(H, W)
    make_model, make_step, batch_np = _case(kind, settings)
    batch = batch_to_torch(batch_np, cuda)
    ctx = make_loss_context(settings, TL, device=cuda, augment=True,
                            aug_max_sp_noise=0.01)

    def fresh():
        model = make_model()
        state = TrainState.create(model, 1e-4, seed=7, device=cuda)
        return state, make_step(model, ctx, state)

    runs = []
    for _ in range(2):
        state, step = fresh()
        assert torch.are_deterministic_algorithms_enabled()
        comps = [step(batch) for _ in range(3)]
        runs.append((state, comps))
    (ref_state, ref), (again_state, again) = runs
    for a, b in zip(ref, again):
        assert torch.equal(a, b)
    for a, b in zip(ref_state.model.parameters(),
                    again_state.model.parameters()):
        assert torch.equal(a, b)

    state, step = fresh()
    for _ in range(2):
        step(batch)
    StateCheckpointer(tmp_path).save(1, state, {"simple": 0.25})
    state2, step2 = fresh()
    _, epoch, min_err = StateCheckpointer(tmp_path).restore(state2)
    assert (epoch, min_err, state2.step) == (1, {"simple": 0.25}, 2)
    assert torch.equal(step2(batch), ref[2])
    for a, b in zip(ref_state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)
    assert state2.rng == ref_state.rng
    assert np.isfinite(ref[2].cpu().numpy()).all()
