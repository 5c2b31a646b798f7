"""One train step of the port against one JAX train step, fullres head.

The cases of ``test_torch_train_step.py`` (see there for the method and the
tolerances) with the ``fullres_mask`` head and the factored 2-D positional
table, in a file of their own: the JAX step of this head takes ~13 s to
build on the CPU.
"""

import pytest
import torch

from test_torch_train_step import check_train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("mode,mask_padding,fused,int16", [
    ("magnitude", True, False, True), ("mask", False, True, False)],
    ids=["magnitude-masked", "mask"])
def test_train_step_matches_jax(mode, mask_padding, fused, int16, rng):
    check_train_step("fullres_mask", mode, mask_padding, "factored_2d", fused, int16, rng)
