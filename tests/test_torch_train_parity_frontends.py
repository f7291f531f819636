"""Training parity with the reference for the frontends: Pixtral's patch
embeddings and SeamlessM4T's encoder over frames with cross-attention, at
``reduced()`` size in f32 on the CPU: loss and metrics, every gradient
leaf, and the parameters after three AdamW steps with f32 and with int8
moments (the limits and their reasons are in ``torch_train_parity.py``)."""
import pytest

import torch_train_parity as parity


@pytest.mark.parametrize("name", ["pixtral-12b", "seamless-m4t-large-v2"])
def test_training_matches_reference(name):
    parity.check(parity.run(name))
