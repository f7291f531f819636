"""The port's sharded train step on gloo ranks (CPU) for reduced xlstm-125m
(the mLSTM's mixing and the sLSTM's time loop each in one region per rank),
held to the port's unsharded step and to the reference's jitted sharded
step on the same mesh shape (Auto axes), as ``test_torch_distributed.py``
holds smollm-135m: the loss within 1e-5 relative and every gradient leaf
within 1e-4 of its leaf's max.

The parameters after 2 AdamW steps are held with f32 moments, each within
``PARAM_ATOL`` (1e-5, the limit ``torch_train_parity.py`` holds the
unsharded xLSTM to against the reference) and the step losses within 1e-5
relative.  The other distribution files' limit of 1e-4 of a leaf's max does
not hold for xLSTM even unsharded: two steps at eps 1e-3 carry xLSTM's f32
differences into the zero-initialised ``ln1/bias``, where the unsharded
port reads 1.16e-4 of its max against the reference (the sharded path of
the parent tree read the same); int8 moments are left out for the same
reason (a (1, 4) run takes one code two steps from the unsharded run's).
"""
import numpy as np
import pytest

import torch_dist_support as sup

CASES = {
    "data4": {"mesh": ((4,), ("data",)), "fsdp": True, "moments": ("float32",)},
    "data2_model2": {"mesh": ((2, 2), ("data", "model")), "fsdp": True,
                     "moments": ("float32",)},
    "model4": {"mesh": ((1, 4), ("data", "model")), "fsdp": True, "moments": ("float32",)},
}
ARCH = 'xlstm-125m'
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sup.run_parity(tmp_path_factory.mktemp("dist"), ARCH, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches(runs, name):
    sup.check_loss(*runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match(runs, name):
    sup.check_grads(*runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_two_steps_match(runs, name):
    ref, port = runs
    got = port[name]["float32"]
    for want in sup._baselines(ref, port, name):
        assert got.keys() == want["float32"].keys()
        errs = {k: float(np.abs(got[k] - want["float32"][k]).max()) for k in got}
        assert max(errs.values()) <= PARAM_ATOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        np.testing.assert_allclose(port[name]["float32_losses"], want["float32_losses"],
                                   rtol=sup.LOSS_RTOL)
