"""Training parity with the reference for the recurrent families: xLSTM
(mLSTM and sLSTM) and Zamba2 (the Mamba-2 SSD scan and the shared
attention block), at ``reduced()`` size in f32 on the CPU: loss and
metrics, every gradient leaf, and the parameters after three AdamW steps
with f32 and with int8 moments (the limits and their reasons are in
``torch_train_parity.py``)."""
import pytest

import torch_train_parity as parity


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-1.2b"])
def test_training_matches_reference(name):
    parity.check(parity.run(name))
