"""Every architecture of octseg_torch over every encoder it supports.

For each of the nine architectures, each of SUPPORTED_ENCODERS is built by
``create_model`` (at the output stride the architecture asks of it) and
its state_dict crosses the weights bridge into flax's layout with nothing
left over: every parameter and running statistic lands in one leaf, of the
same element count. The modules are built on the meta device (the
constructors run in full; no memory is allocated and no initializer runs)
and the bridge reads uninitialized one-byte numpy arrays of the
state_dict's shapes (it moves values and never reads their type), so the
144 pairs take seconds, not minutes. Values crossing the bridge are
tests/test_torch_zoo_convert.py's.
"""

import jax
import numpy as np
import pytest
import torch

from octseg_torch.models import SUPPORTED_ARCHITECTURES, SUPPORTED_ENCODERS, create_model
from octseg_torch.models.convert import state_dict_to_variables


@pytest.mark.parametrize('arch', SUPPORTED_ARCHITECTURES)
def test_every_encoder_builds_and_crosses_the_bridge(arch):
    assert len(SUPPORTED_ENCODERS) == 16
    for encoder in SUPPORTED_ENCODERS:
        with torch.device('meta'):
            model = create_model(arch, encoder)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
                  if not k.endswith('num_batches_tracked')}
        variables = state_dict_to_variables(
            {k: np.empty(s, np.uint8) for k, s in shapes.items()}, arch, encoder)
        leaves = jax.tree_util.tree_leaves(variables)
        assert len(leaves) == len(shapes), f'{arch}/{encoder}'
        assert sum(v.size for v in leaves) == sum(int(np.prod(s)) for s in shapes.values()), (
            f'{arch}/{encoder}')
