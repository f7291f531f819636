"""Training parity with the reference for the dense GQA decoders, at
``reduced()`` size in f32 on the CPU: loss and metrics, every gradient
leaf, and the parameters after three AdamW steps with f32 and with int8
moments (the limits and their reasons are in ``torch_train_parity.py``)."""
import pytest

import torch_train_parity as parity


@pytest.mark.parametrize("name", ["chatglm3-6b", "mistral-large-123b", "nemotron-4-340b",
                                  "smollm-135m"])
def test_training_matches_reference(name):
    parity.check(parity.run(name))
