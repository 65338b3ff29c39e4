"""One train step of the zoo's decoders over dilated encoders, octseg_torch
against the JAX package on the CPU: PAN (output stride 16, at 128 px),
DeepLabV3 (8) and DeepLabV3Plus (16) over resnet18 at 64 px, as
tests/test_torch_zoo_train.py checks the others (its module docstring has
the bounds), in fp32 and in bf16 with remat. A file of their own, so the
test runner's per-file workers run them beside those.
"""

import pytest

from tests.test_torch_zoo_convert import one_thread  # noqa: F401 (a fixture)
from tests.test_torch_zoo_train import check_bf16_remat_step, check_train_step


@pytest.mark.parametrize('arch', ['PAN', 'DeepLabV3', 'DeepLabV3Plus'])
def test_dilated_zoo_train_step_matches_jax(arch, monkeypatch):
    check_train_step(arch, monkeypatch)


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('arch', ['PAN', 'DeepLabV3', 'DeepLabV3Plus'])
def test_dilated_zoo_bf16_remat_step_as_close_to_fp32_as_octsegs_bf16(arch, monkeypatch):
    check_bf16_remat_step(arch, monkeypatch)
