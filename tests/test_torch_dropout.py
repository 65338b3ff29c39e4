"""The port's dropout (models/common.py): drawn from a generator the caller
passes, never from torch's global RNG.

Dropout2d (FPN, PSPNet) zeroes whole channels and elementwise Dropout
(DeepLab's ASPP) zeroes single elements; the kept share lies within a
binomial bound (6 standard deviations), kept values are scaled by 1/(1-p),
both are the identity in eval mode and at p = 0, the same generator seed
gives the same masks and the next draw gives others, and train mode without
a generator raises.
"""

import math

import pytest
import torch

from octseg_torch.models import create_model
from octseg_torch.models.common import Dropout, Dropout2d, set_dropout_generator


def _draw(layer, x, seed):
    set_dropout_generator(layer, torch.Generator().manual_seed(seed))
    return layer.train()(x)


@pytest.mark.parametrize('cls,p', [(Dropout2d, 0.2), (Dropout, 0.5), (Dropout2d, 0.7)])
def test_dropout_masks_scale_and_share(cls, p):
    x = torch.rand(8, 64, 12, 10) + 0.5      # no zero in the input
    y = _draw(cls(p), x, 0)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=1e-6, atol=0)
    if cls is Dropout2d:
        # a channel is all kept or all dropped
        per_channel = kept.flatten(2).float().mean(-1)
        assert set(per_channel.unique().tolist()) <= {0.0, 1.0}
        n, share = per_channel.numel(), per_channel.mean().item()
    else:
        n, share = kept.numel(), kept.float().mean().item()
        # not a channel mask: channels hold both kept and dropped elements
        assert ((kept.flatten(2).float().mean(-1) % 1) > 0).any()
    sd = math.sqrt(p * (1 - p) / n)
    assert abs(share - (1 - p)) <= 6 * sd, (share, 1 - p, sd)


@pytest.mark.parametrize('cls', [Dropout2d, Dropout])
def test_dropout_seeds_and_modes(cls):
    x = torch.rand(4, 16, 6, 6) + 0.5
    layer = cls(0.3)
    first = _draw(layer, x, 7)
    assert torch.equal(_draw(layer, x, 7), first)          # same seed, same mask
    gen = torch.Generator().manual_seed(7)
    set_dropout_generator(layer, gen)
    a, b = layer(x), layer(x)                             # the next draw differs
    assert torch.equal(a, first) and not torch.equal(a, b)
    torch.manual_seed(0)
    before = torch.rand(3)
    torch.manual_seed(0)
    _draw(layer, x, 1)
    assert torch.equal(torch.rand(3), before)           # the global RNG is untouched
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(_draw(cls(0.0), x, 1), x)
    with pytest.raises(RuntimeError, match='needs a generator'):
        cls(0.3).train()(x)


@pytest.mark.parametrize('arch,names', [
    ('FPN', {'decoder.dropout': (Dropout2d, 0.2)}),
    ('PSPNet', {'decoder.dropout': (Dropout2d, 0.2)}),
    ('DeepLabV3', {'decoder.0.project.3': (Dropout, 0.5)}),
    ('DeepLabV3Plus', {'decoder.aspp.0.project.3': (Dropout, 0.5)}),
    ('PAN', {}), ('MAnet', {}), ('Unet', {})])
def test_models_carry_octseg_dropouts(arch, names):
    model = create_model(arch, 'resnet18')
    found = {name: (type(m), m.p) for name, m in model.named_modules()
             if isinstance(m, (Dropout, Dropout2d))}
    assert found == names
    assert not any(isinstance(m, torch.nn.modules.dropout._DropoutNd)
                   for m in model.modules())
