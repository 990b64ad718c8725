"""The training loss and its gradient against the reference's on the other
five reduced archs (the MoE with shared experts, the Mamba-2 hybrid, the
VLM's frontend, MLA and the encoder-decoder); the check and its
tolerances are ``test_torch_train_loss.py``'s."""

import numpy as np
import pytest

from test_torch_train_loss import check_loss_and_grads

ARCHS = ["moonshot-v1-16b-a3b", "zamba2-7b", "internvl2-76b",
         "minicpm3-4b", "whisper-tiny"]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference_more(name):
    loss = check_loss_and_grads(name)
    assert abs(loss - np.log(256)) < 3.0
