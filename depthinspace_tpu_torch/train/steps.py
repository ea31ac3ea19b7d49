"""DIS-SF and DIS-MF train and evaluation steps, port of
``depthinspace_tpu/train/steps.py::_make_step_fns``.

The train step runs the forward, the loss vector, backward and one Adam
update, eagerly; the eval step runs the forward and the components under
``torch.inference_mode()`` and returns disp0 quantized to u16 x256 (1/256
px) as the JAX step does. Both decode the batch's 16-bit wire fields
first (``data/wire.py::decode_batch``; float32 fields pass through), then
apply the flow source (``rigid`` computes the flow from the GT disparity;
``net`` runs the frozen FlowNet on the decoded images, without gradient;
for DIS-MF ``pred`` computes it from the primary disparity); for DIS-SF
with ``flow_source="pred"`` the flow comes from the live prediction inside
``sf_losses``.

Data parallel (``ctx.group`` set): each rank runs its block of the global
batch (``parallel/mesh.py::shard_batch``), its losses are its shares of the
global-batch losses (``losses/reduce.py``), and after the accumulation loop
one all-reduce of the flattened gradients sums the shares, as the JAX
mesh step's one psum does; then every rank takes the same Adam step.
"""

from __future__ import annotations

import torch

from ..data.batch import Batch
from ..data.wire import decode_batch, to_u16_disp
from ..ops import disp_to_depth
from ..parallel.multihost import all_reduce_sum
from .objective import (LossContext, augment_batch_device, draw_augment,
                        mf_losses, prepare_batch, preprocess_images, sf_losses)
from .state import TrainState


def _sf_forward(model, batch: Batch, ctx: LossContext):
    net_in, *_ = preprocess_images(batch, ctx.lcn_radius)
    return model(net_in)            # 4 x (tl*bs, H, W, 1)


def _mf_forward(model, batch: Batch, ctx: LossContext):
    tl, bs, H, W = batch.im.shape
    net_in, *_ = preprocess_images(batch, ctx.lcn_radius)
    pdisp = batch.primary_disp[..., None]
    pdepth = disp_to_depth(pdisp, ctx.focal_length, ctx.baseline)
    return model(net_in.reshape(tl, bs, H, W, 2), batch.ambient[..., None],
                 pdisp, pdepth, batch.R, batch.t, batch.flow)  # (tl,bs,H,W,1)


# (forward, losses, disp0 (tl, bs, H, W) of the forward's output)
_ARCH = {
    "single_frame": (_sf_forward, sf_losses,
                     lambda outs, b: outs[0][..., 0].reshape(b.im.shape)),
    "multi_frame": (_mf_forward, mf_losses, lambda out, b: out[..., 0]),
}


def chunk_batch(batch: Batch, k: int) -> list[Batch]:
    """Split the batch-size axis into k consecutive microbatches, as
    ``_chunk_batch`` does with one data-parallel shard. Every field is
    (tl, bs, ...) except flow, (tl, tl, bs, ...).

    Under data parallelism the JAX step chunks the *global* batch into k
    contiguous ranges; a rank's local batch holds its block of each range
    in range order (``parallel/mesh.py::shard_batch`` with ``accum=k``),
    so microbatch j here is the rank's share of global microbatch j."""
    def split(name, x, i):
        if x is None:
            return None
        a = 2 if name == "flow" else 1
        bs = x.shape[a]
        if bs % k:
            raise ValueError(f"batch size {bs} not divisible by accum={k}")
        per = bs // k
        return x.narrow(a, i * per, per)
    return [Batch(**{f: split(f, getattr(batch, f), i)
                     for f in Batch._fields}) for i in range(k)]


def _make_train_step(architecture: str, model: torch.nn.Module,
                     ctx: LossContext, state: TrainState, accum_steps: int):
    forward, losses, _ = _ARCH[architecture]
    multi_frame = architecture == "multi_frame"
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Batch, epoch: float = 0) -> torch.Tensor:
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        batch = decode_batch(batch)
        comps_sum = None
        chunks = chunk_batch(batch, accum_steps) if accum_steps > 1 \
            else [batch]
        for b in chunks:
            if ctx.augment:
                tl, bs, H, W = b.im.shape
                b = augment_batch_device(b, draw_augment(
                    tl * bs, H, W, ctx, state.generator))
            b = prepare_batch(b, ctx, multi_frame)
            outs = forward(model, b, ctx)
            total, comps = losses(outs, b, ctx, train=True, epoch=epoch,
                                  generator=state.generator)
            total.backward()
            comps = comps.detach()
            comps_sum = comps if comps_sum is None else comps_sum + comps
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            comps_sum = comps_sum * inv
        if ctx.group is not None:
            _all_reduce_grads(params, ctx.group)
        state.optimizer.step()
        state.step += 1
        return comps_sum

    return train_step


def _all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over the ranks, in one collective on
    a flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _make_eval_step(architecture: str, model: torch.nn.Module,
                    ctx: LossContext):
    forward, losses, take_disp0 = _ARCH[architecture]
    multi_frame = architecture == "multi_frame"

    @torch.inference_mode()
    def eval_step(batch: Batch, epoch: float = 0):
        batch = prepare_batch(decode_batch(batch), ctx, multi_frame)
        outs = forward(model, batch, ctx)
        _, comps = losses(outs, batch, ctx, train=False, epoch=epoch)
        return to_u16_disp(take_disp0(outs, batch)), comps

    return eval_step


def make_sf_train_step(model: torch.nn.Module, ctx: LossContext,
                       state: TrainState, accum_steps: int = 1):
    """Returns ``train_step(batch, epoch=0) -> components`` (a detached
    float32 tensor), which updates ``model`` through ``state.optimizer`` and
    advances ``state.step``.

    ``accum_steps > 1`` runs forward and backward over bs/accum consecutive
    microbatches, sums their gradients, scales the sum by 1/accum and takes
    one optimizer step; the components are the microbatches' mean. The
    gradients stay on the parameters until the next step."""
    return _make_train_step("single_frame", model, ctx, state, accum_steps)


def make_mf_train_step(model: torch.nn.Module, ctx: LossContext,
                       state: TrainState, accum_steps: int = 1):
    """The DIS-MF train step, as :func:`make_sf_train_step`; ``batch`` must
    carry ``primary_disp``. With accumulation the masked-mean terms
    normalize by each microbatch's own mask count, as in the JAX package."""
    return _make_train_step("multi_frame", model, ctx, state, accum_steps)


def make_sf_eval_step(model: torch.nn.Module, ctx: LossContext):
    """Returns ``eval_step(batch, epoch=0) -> (disp0_u16 (tl, bs, H, W)
    uint16, components float32)``; ``batch`` holds float32 or wire-encoded
    tensors on the model's device (``data.batch_to_torch``)."""
    return _make_eval_step("single_frame", model, ctx)


def make_mf_eval_step(model: torch.nn.Module, ctx: LossContext):
    """The DIS-MF eval step, as :func:`make_sf_eval_step`."""
    return _make_eval_step("multi_frame", model, ctx)
