"""Training parity with the reference for the MoE families: Mixtral (the
aux loss, the sliding window) and DeepSeek-V3 (MLA, routed and shared
experts, the aux and MTP terms), at ``reduced()`` size in f32 on the CPU:
loss and metrics, every gradient leaf, and the parameters after three
AdamW steps with f32 and with int8 moments (the limits and their reasons
are in ``torch_train_parity.py``)."""
import pytest

import torch_train_parity as parity


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "mixtral-8x7b"])
def test_training_matches_reference(name):
    parity.check(parity.run(name))
