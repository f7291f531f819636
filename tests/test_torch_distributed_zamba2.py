"""The port's sharded train step on gloo ranks (CPU) for reduced zamba2-1.2b (Mamba-2 layers through the SSD
scan's per-rank region, and the shared attention block),
 held to the port's unsharded step and to the reference's jitted sharded
step on the same mesh shape (Auto axes), as ``test_torch_distributed.py``
holds smollm-135m: the loss within 1e-5 relative, every gradient leaf and
every parameter after 2 AdamW steps (f32 and int8 moments) within 1e-4 of
its leaf's max (int8 as ``torch_dist_support.check_int8`` holds it)."""
import pytest

import torch_dist_support as sup

CASES = {
    "data4": {"mesh": ((4,), ("data",)), "fsdp": True},
    "data2_model2": {"mesh": ((2, 2), ("data", "model")), "fsdp": True},
    "model4": {"mesh": ((1, 4), ("data", "model")), "fsdp": True},
}
ARCH = 'zamba2-1.2b'


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sup.run_parity(tmp_path_factory.mktemp("dist"), ARCH, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches(runs, name):
    sup.check_loss(*runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match(runs, name):
    sup.check_grads(*runs, name)


@pytest.mark.parametrize("moment", ["float32", "int8"])
@pytest.mark.parametrize("name", list(CASES))
def test_params_after_two_steps_match(runs, name, moment):
    sup.check_params(*runs, name, moment)
