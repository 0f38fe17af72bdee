"""Shared model bases for the zoo, ported from
``singa_tpu/models/_base.py``."""

from __future__ import annotations

import torch

from .. import autograd, model

__all__ = ["Classifier"]


def _cast_to_compute(x, device) -> torch.Tensor:
    """`x` on the model's device; a float input in another dtype than
    the device's compute dtype is cast to it when that is not f32 (bf16
    on the card), so convolutions and products run in bf16.  Parameters
    follow the activations' dtype (``layer._maybe_cast``); BatchNorm
    keeps f32 statistics."""
    x = torch.as_tensor(x, device=device.torch_device)
    dt = device.default_dtype
    if dt != torch.float32 and x.is_floating_point() and x.dtype != dt:
        return autograd.cast(x, dt)
    return x


class Classifier(model.Model):
    """The reference's classification step: forward, softmax cross
    entropy, ``optimizer(loss)``.  Float inputs enter at the device's
    compute dtype; logits are returned, and the loss computed, in f32."""

    def __call__(self, *xs):
        """Logits of `xs`; as in the reference, a call records the
        backward's graph only in training mode."""
        xs = tuple(_cast_to_compute(x, self.device) for x in xs)
        with torch.set_grad_enabled(autograd.is_training()):
            return super().__call__(*xs).float()

    def train_one_batch(self, x, y):
        out = self.forward(_cast_to_compute(x, self.device)).float()
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss
