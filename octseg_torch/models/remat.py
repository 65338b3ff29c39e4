"""Per-block activation rematerialization (gradient checkpointing).

The port of octseg/models/rematutil.py. A block that subclasses
``RematBlock`` runs under ``torch.utils.checkpoint`` (non-reentrant) when
its ``remat`` flag is set and autograd is recording: its activations are
dropped after the forward and recomputed, one block at a time, in the
backward. ``set_block_remat(model, True)`` sets the flag on every such
block of a model (``create_model(..., remat=True)`` does it); the flag is
the model's, not the process's. Parameter names and checkpoints are the
same with and without it.

The blocks are the ones octseg wraps in ``maybe_remat``: the resnet blocks,
``MBConv``, ``RegNetBlock``, the Unet ``DecoderBlock`` and the LinkNet
decoder block; the port also wraps UNet++'s grid nodes (the same
``DecoderBlock``) and LinkNet's last block, which only lowers memory.

A checkpointed block runs its forward twice in a step. flax's
recomputation is functional, so its BatchNorm running statistics move once;
here the second run happens inside ``recomputing()``, and
``common.BatchNorm2d`` leaves the statistics alone there.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_state = threading.local()


def recomputing() -> bool:
    """True while a checkpointed block is being recomputed in this thread."""
    return getattr(_state, 'recomputing', False)


@contextlib.contextmanager
def _recomputation():
    prev = recomputing()
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = prev


def _contexts():
    # (context of the first forward, context of the recomputation)
    return contextlib.nullcontext(), _recomputation()


class RematBlock(nn.Module):
    """A module whose call is checkpointed when ``remat`` is set and
    autograd is recording."""

    remat = False

    def __call__(self, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(super().__call__, *args, use_reentrant=False,
                              context_fn=_contexts)
        return super().__call__(*args)


def set_block_remat(model: nn.Module, enabled: bool) -> nn.Module:
    """Checkpoint every ``RematBlock`` of ``model`` (or none). Returns it."""
    for mod in model.modules():
        if isinstance(mod, RematBlock):
            mod.remat = bool(enabled)
    return model
